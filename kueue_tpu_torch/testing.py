"""Seeded random packed planes for kernel parity checks.

Each generator draws, from a ``numpy.random.Generator``, the numpy arrays
one kernel takes, laid out exactly as the packer lays them out: CQs are
nodes 0..C-1 and cohorts follow, parents point up a forest of the given
depth, heads past the real count are padding (``wl_cq = -1``), ``order``
is a permutation, decision pairs name distinct flavor-resources, and
preemption targets overlap between heads.  The same arrays go to the JAX
package and to this one (tests), or to a CUDA kernel and its plain
version (``chip_smoke.py``).
"""

from __future__ import annotations

import numpy as np

I32_LIMIT = (2**31 - 1) // 64       # the packer's "no limit" sentinel
BORROW_CAP_NONE = 2**30             # preemption_solver's forest-plane pad


def forest(rng: np.random.Generator, n_cqs: int, n_cohorts: int,
           depth: int, chain: bool = False, roots: int = 0, per: int = 0):
    """parent [N] (CQs first, then cohorts), forest_of_node [N],
    n_forests, and the true depth (<= ``depth`` levels).  ``chain``: the
    cohorts form one line (cohort j under cohort j - 1) and every CQ sits
    under a cohort, CQ 0 under the deepest, so the tree is
    ``n_cohorts + 1`` levels deep whatever ``depth`` says.  ``roots``:
    exactly that many forests — the first ``roots`` cohorts are roots,
    the others nest under earlier ones (``depth`` >= 3), every CQ sits
    under a cohort.  ``per``: every cohort a root over ``per`` CQs (CQ c
    under cohort c // per), the CQs past n_cohorts x per parentless —
    the north star's cohorts of five."""
    N = n_cqs + n_cohorts
    parent = np.full(N, -1, dtype=np.int32)
    level = np.zeros(N, dtype=np.int32)
    if per:
        held = min(n_cqs, n_cohorts * per)
        parent[:held] = n_cqs + np.arange(held) // per
        level[:held] = 1
        roots, n_cohorts = 0, 0      # the loops below then draw nothing
    if roots:
        for j in range(roots, n_cohorts):
            cands = [n_cqs + i for i in range(j)
                     if level[n_cqs + i] < depth - 2]
            if not cands:
                raise ValueError("roots: nested cohorts need depth >= 3")
            p = int(rng.choice(cands))
            parent[n_cqs + j] = p
            level[n_cqs + j] = level[p] + 1
        parent[:n_cqs] = n_cqs + rng.integers(0, n_cohorts, n_cqs)
        level[:n_cqs] = level[parent[:n_cqs]] + 1
    elif chain and n_cohorts:
        parent[n_cqs + 1:] = np.arange(n_cqs, N - 1)
        level[n_cqs:] = np.arange(n_cohorts)
        parent[:n_cqs] = n_cqs + rng.integers(0, n_cohorts, n_cqs)
        parent[0] = N - 1
        level[:n_cqs] = level[parent[:n_cqs]] + 1
        return parent, np.zeros(N, dtype=np.int32), 1, n_cohorts + 1
    # cohorts: each picks a parent cohort one level up, keeping the
    # cohort levels within depth - 1 so a CQ below fits in depth levels
    for j in range(n_cohorts if not roots else 0):
        node = n_cqs + j
        if j > 0 and depth > 2 and rng.random() < 0.6:
            cands = [n_cqs + i for i in range(j) if level[n_cqs + i] < depth - 2]
            if cands:
                p = int(rng.choice(cands))
                parent[node] = p
                level[node] = level[p] + 1
    for c in range(n_cqs if not roots else 0):
        if n_cohorts and depth > 1 and rng.random() < 0.85:
            p = n_cqs + int(rng.integers(n_cohorts))
            parent[c] = p
            level[c] = level[p] + 1
    roots = {}
    forest_of = np.zeros(N, dtype=np.int32)
    for n in range(N):
        r = n
        while parent[r] >= 0:
            r = parent[r]
        forest_of[n] = roots.setdefault(r, len(roots))
    return parent, forest_of, len(roots), int(level.max()) + 1


def quota_planes(rng: np.random.Generator, N: int, F: int,
                 blim_none: int = I32_LIMIT) -> dict:
    guaranteed = rng.integers(0, 20, (N, F)).astype(np.int32)
    subtree = (guaranteed + rng.integers(0, 40, (N, F))).astype(np.int32)
    has_blim = rng.random((N, F)) < 0.5
    borrow_cap = np.where(has_blim, rng.integers(0, 60, (N, F)),
                          blim_none).astype(np.int32)
    usage = rng.integers(0, 30, (N, F)).astype(np.int32)
    return dict(usage0=usage, subtree=subtree, guaranteed=guaranteed,
                borrow_cap=borrow_cap, has_blim=has_blim)


def _pairs(rng, W: int, R: int, F: int, mask: np.ndarray, lo=1, hi=15):
    fr = np.full((W, R), -1, dtype=np.int32)
    amt = np.zeros((W, R), dtype=np.int32)
    for w in np.nonzero(mask)[0]:
        k = int(rng.integers(1, min(R, F) + 1))
        cols = rng.choice(F, size=k, replace=False)
        slots = rng.choice(R, size=k, replace=False)
        fr[w, slots] = cols
        amt[w, slots] = rng.integers(lo, hi, k)
    return fr, amt


def admit_cycle(rng: np.random.Generator, *, n_cqs: int = 6,
                n_cohorts: int = 3, depth: int = 3, F: int = 2, W: int = 16,
                R: int = 2, n_valid: int | None = None,
                reserve: bool = True, chain: bool = False,
                roots: int = 0, per: int = 0) -> dict:
    """Inputs of admit_scan / admit_scan_forests (with ``forest_of_node``,
    ``n_forests`` and ``max_forest_wl``), as numpy arrays; ``depth`` is
    the static depth argument (``chain``, ``roots`` and ``per`` as
    ``forest``)."""
    parent, forest_of, n_forests, true_depth = forest(rng, n_cqs, n_cohorts,
                                                      depth, chain, roots,
                                                      per)
    N = n_cqs + n_cohorts
    q = quota_planes(rng, N, F)
    nominal = rng.integers(0, 30, (n_cqs, F)).astype(np.int32)
    npb = np.where(rng.random((n_cqs, F)) < 0.5,
                   nominal + rng.integers(0, 40, (n_cqs, F)),
                   I32_LIMIT).astype(np.int32)
    n_valid = W if n_valid is None else n_valid
    wl_cq = np.full(W, -1, dtype=np.int32)
    wl_cq[:n_valid] = rng.integers(0, n_cqs, n_valid)
    fit_mask = (rng.random(W) < 0.7) & (wl_cq >= 0)
    res_mask = (~fit_mask & (rng.random(W) < 0.6) & (wl_cq >= 0)
                if reserve else np.zeros(W, dtype=bool))
    dec_fr, dec_amt = _pairs(rng, W, R, F, fit_mask)
    res_fr, res_amt = _pairs(rng, W, R, F, res_mask)
    res_borrows = (rng.random(W) < 0.5) & res_mask
    order = rng.permutation(W).astype(np.int32)
    f_w = forest_of[np.maximum(wl_cq, 0)][wl_cq >= 0]
    mfw = int(np.bincount(f_w, minlength=n_forests).max()) if len(f_w) else 1
    bucket = 4
    while bucket < mfw:
        bucket *= 2
    return dict(q, parent=parent, nominal_cq=nominal, npb_cq=npb,
                wl_cq=wl_cq, dec_fr=dec_fr, dec_amt=dec_amt,
                fit_mask=fit_mask, res_fr=res_fr, res_amt=res_amt,
                res_mask=res_mask, res_borrows=res_borrows, order=order,
                forest_of_node=forest_of, n_forests=n_forests,
                max_forest_wl=bucket, depth=max(depth, true_depth))


def preempt_cycle(rng: np.random.Generator, *, T: int = 64, MT: int = 4,
                  n_targets: int | None = None, in_forest: bool = False,
                  **kw) -> dict:
    """Inputs of admit_scan_preempt: ``admit_cycle`` plus preempt heads
    whose target lists overlap; ``in_forest``: each head's targets in
    its own cohort forest, as a Kueue cycle has them (the forest-sharded
    scans need it)."""
    a = admit_cycle(rng, **kw)
    W = a["wl_cq"].shape[0]
    F = a["usage0"].shape[1]
    n_cqs = a["nominal_cq"].shape[0]
    valid = a["wl_cq"] >= 0
    pmask = ~a["fit_mask"] & (rng.random(W) < 0.5) & valid
    a["res_mask"] &= ~pmask
    a["res_borrows"] &= a["res_mask"]
    R = a["res_fr"].shape[1]
    pre_fr, pre_amt = _pairs(rng, W, R, F, pmask)
    n_targets = min(T, max(1, W // 2)) if n_targets is None else n_targets
    tgt_mat = np.full((W, MT), -1, dtype=np.int32)
    tu_cq = np.zeros(T, dtype=np.int32)
    if in_forest:
        tu_cq[:n_targets] = rng.integers(0, n_cqs, n_targets)
        fon = a["forest_of_node"]
        for w in np.nonzero(pmask)[0]:
            pool = np.flatnonzero(fon[tu_cq[:n_targets]]
                                  == fon[a["wl_cq"][w]])
            k = int(rng.integers(0, min(MT, len(pool)) + 1))
            tgt_mat[w, :k] = rng.choice(pool, size=k, replace=False)
    else:
        for w in np.nonzero(pmask)[0]:
            k = int(rng.integers(1, min(MT, n_targets) + 1))
            # a small universe makes target lists overlap between heads
            tgt_mat[w, :k] = rng.choice(n_targets, size=k, replace=False)
        tu_cq[:n_targets] = rng.integers(0, n_cqs, n_targets)
    tu_delta = np.zeros((T, F), dtype=np.int32)
    tu_delta[:n_targets] = rng.integers(0, 12, (n_targets, F))
    a.update(preempt_mask=pmask, pre_fr=pre_fr, pre_amt=pre_amt,
             tgt_mat=tgt_mat, tu_cq=tu_cq, tu_delta=tu_delta)
    return a


def preemption_searches(rng: np.random.Generator, *, S: int = 32,
                        n_valid: int | None = None, K: int = 16,
                        n_cands: int | None = None, n_cqs: int = 4,
                        n_cohorts: int = 2, depth: int = 3,
                        F: int = 2, chain: bool = False) -> dict:
    """Inputs of minimal_preemptions_batch: S forest-local searches over
    [S, NL, F] planes, padded searches (pre_cq = -1) past ``n_valid``
    (``chain`` as ``forest``)."""
    NL = n_cqs + n_cohorts
    n_valid = S if n_valid is None else n_valid
    planes = {k: [] for k in ("usage0", "subtree", "guaranteed",
                              "borrow_cap", "has_blim", "parent")}
    depths = []
    for _ in range(S):
        parent, _, _, d = forest(rng, n_cqs, n_cohorts, depth, chain)
        depths.append(d)
        q = quota_planes(rng, NL, F, blim_none=BORROW_CAP_NONE)
        q["parent"] = parent
        for k in planes:
            planes[k].append(q[k])
    out = {k: np.stack(v) for k, v in planes.items()}
    pre_cq = np.full(S, -1, dtype=np.int32)
    pre_cq[:n_valid] = rng.integers(0, n_cqs, n_valid)
    wl_usage = rng.integers(0, 20, (S, F)).astype(np.int32)
    frs_mask = rng.random((S, F)) < 0.7
    n_cands = K if n_cands is None else n_cands
    cand_cq = np.full((S, K), -1, dtype=np.int32)
    cand_cq[:, :n_cands] = rng.integers(0, n_cqs, (S, n_cands))
    cand_delta = np.zeros((S, K, F), dtype=np.int32)
    cand_delta[:, :n_cands] = rng.integers(0, 12, (S, n_cands, F))
    cand_other = (cand_cq != pre_cq[:, None]) & (cand_cq >= 0)
    cand_above = rng.random((S, K)) < 0.3
    allow_b0 = rng.random(S) < 0.5
    thr_en = rng.random(S) < 0.5
    out.update(pre_cq=pre_cq, wl_usage=wl_usage, frs_mask=frs_mask,
               cand_cq=cand_cq, cand_delta=cand_delta,
               cand_other_cq=cand_other, cand_above_threshold=cand_above,
               allow_borrowing0=allow_b0, threshold_enabled=thr_en,
               depth=max(depth, max(depths)))
    return out


# argument order of each kernel's positional arrays
ADMIT_ARGS = ("usage0", "subtree", "guaranteed", "borrow_cap", "has_blim",
              "parent", "nominal_cq", "npb_cq", "wl_cq", "dec_fr", "dec_amt",
              "fit_mask", "res_fr", "res_amt", "res_mask", "res_borrows")
PREEMPT_ARGS = ("preempt_mask", "pre_fr", "pre_amt", "tgt_mat", "tu_cq",
                "tu_delta")
SEARCH_ARGS = ("usage0", "subtree", "guaranteed", "borrow_cap", "has_blim",
               "parent", "pre_cq", "wl_usage", "frs_mask", "cand_cq",
               "cand_delta", "cand_other_cq", "cand_above_threshold",
               "allow_borrowing0", "threshold_enabled")


def admit_args(case: dict) -> tuple:
    """admit_scan's positional arrays (``order`` last)."""
    return tuple(case[k] for k in ADMIT_ARGS) + (case["order"],)


def forest_args(case: dict) -> tuple:
    return admit_args(case) + (case["forest_of_node"],)


def preempt_args(case: dict) -> tuple:
    return (tuple(case[k] for k in ADMIT_ARGS)
            + tuple(case[k] for k in PREEMPT_ARGS) + (case["order"],))


def preempt_tables(args) -> tuple:
    """``admit_scan_preempt``'s forest tables for its positional arrays
    (``preempt_args``): each node's tree, with the forests that a
    preempting head and its targets connect joined
    (``ops.cycle.join_target_forests``) → (forest_of_node [N] int32,
    n_forests)."""
    from .ops.cycle import join_target_forests
    from .parallel.sharded import forests_of_parent
    args = [np.asarray(a) for a in args]
    fon = forests_of_parent(args[5])
    n = int(fon.max()) + 1
    labels, _ = join_target_forests(fon, n, args[8], args[16], args[19],
                                    args[20])
    return np.ascontiguousarray(labels, dtype=np.int32), n


def search_args(case: dict) -> tuple:
    return tuple(case[k] for k in SEARCH_ARGS)


# -- the standard sweep a CUDA kernel is held to against its plain version

# (n_cqs, n_cohorts, depth, F, W, R, n_valid)
ADMIT_SHAPES = [
    (6, 3, 1, 1, 8, 1, 8),
    (8, 4, 2, 4, 32, 3, 30),
    (60, 20, 3, 3, 32, 2, 28),          # N > 64
    (6, 3, 3, 12, 16, 4, 16),           # F = 12
    (200, 50, 3, 2, 1024, 2, 1000),
    (19000, 1000, 3, 3, 64, 2, 60),     # usage plane beyond shared memory
]
# (n_cqs, n_cohorts, depth, F, W, R, n_valid, max_forest_wl or None)
FOREST_SHAPES = [
    (30, 10, 2, 1, 64, 1, 60, None),
    (60, 20, 3, 2, 128, 2, 120, None),
    (60, 20, 3, 2, 128, 2, 128, 4),     # heads past max_forest_wl
    (40, 10, 3, 12, 64, 4, 64, None),   # F = 12
    (1000, 200, 2, 1, 1024, 1, 1024, None),
]
# (n_cqs, n_cohorts, depth, F, W, R, T, MT, n_targets)
PREEMPT_SHAPES = [
    (6, 3, 2, 1, 8, 1, 64, 4, 4),
    (8, 4, 3, 2, 32, 2, 64, 4, 10),
    (8, 4, 3, 3, 32, 2, 512, 16, 12),
    (60, 20, 3, 2, 32, 2, 64, 4, 8),    # N > 64
    (6, 3, 3, 12, 16, 4, 64, 4, 6),     # F = 12
    (200, 50, 3, 2, 1024, 2, 4096, 16, 600),
    (6500, 500, 3, 3, 64, 2, 64, 4, 20),  # planes beyond shared memory
]
# (S, n_valid, K, n_cands, n_cqs, n_cohorts, depth, F)
SEARCH_SHAPES = [
    (32, 32, 16, 16, 4, 2, 2, 1),
    (32, 20, 128, 40, 6, 3, 3, 3),
    (32, 32, 16, 16, 4, 2, 3, 12),      # F = 12
    (256, 200, 16, 12, 4, 2, 3, 1),
    (256, 256, 128, 100, 6, 3, 3, 2),
    (1, 1, 16, 16, 29000, 1000, 3, 2),  # plane beyond shared memory
]


# minimal_preemptions_batch's layouts on the card: (label, the
# preemption_searches keyword arguments, the route search_layout takes)
SEARCH_ROUTE_CASES = [
    ("S_13", dict(S=13, n_valid=9, K=16, n_cands=12, F=2), "shared"),
    ("K_1024", dict(S=6, K=1024, n_cands=1000, F=2), "shared"),
    ("F_40", dict(S=8, K=128, n_cands=60, n_cqs=6, n_cohorts=3, F=40),
     "shared"),
    ("NL_30000", dict(S=2, K=16, n_cands=16, n_cqs=29000, n_cohorts=1000,
                      F=2), "tree global"),
    ("cands_global", dict(S=5, K=1024, n_cands=40, F=64),
     "candidates global"),
    ("both_global", dict(S=2, K=1024, n_cands=30, n_cqs=19000,
                         n_cohorts=1000, F=64), "global"),
]


def search_route_cases(seed: int = 0):
    """Yield (label, minimal_preemptions_batch's numpy arrays, keyword
    arguments, route) over ``SEARCH_ROUTE_CASES``: an S that is not a
    multiple of the searches per block, K = 1,024, F past a warp's
    lanes, a tree past shared memory, candidates past it, and both; the
    searches shuffled so that padding searches lie between real ones."""
    rng = np.random.default_rng(seed)
    for label, kw, route in SEARCH_ROUTE_CASES:
        c = preemption_searches(rng, **kw)
        perm = rng.permutation(kw["S"])
        for k in SEARCH_ARGS:
            c[k] = np.ascontiguousarray(c[k][perm])
        yield label, search_args(c), dict(depth=c["depth"]), route


def kernel_cases(seed: int = 0):
    """Yield (kernel name, positional numpy arrays, keyword arguments)
    over the standard sweep of every kernel."""
    rng = np.random.default_rng(seed)
    for n_cqs, n_coh, depth, F, W, R, n_valid in ADMIT_SHAPES:
        c = admit_cycle(rng, n_cqs=n_cqs, n_cohorts=n_coh, depth=depth, F=F,
                        W=W, R=R, n_valid=n_valid)
        yield "admit_scan", admit_args(c), dict(depth=c["depth"])
    for n_cqs, n_coh, depth, F, W, R, n_valid, cap in FOREST_SHAPES:
        c = admit_cycle(rng, n_cqs=n_cqs, n_cohorts=n_coh, depth=depth, F=F,
                        W=W, R=R, n_valid=n_valid)
        yield "admit_scan_forests", forest_args(c), dict(
            depth=c["depth"], n_forests=c["n_forests"],
            max_forest_wl=cap or c["max_forest_wl"])
    for n_cqs, n_coh, depth, F, W, R, T, MT, n_tg in PREEMPT_SHAPES:
        c = preempt_cycle(rng, n_cqs=n_cqs, n_cohorts=n_coh, depth=depth,
                          F=F, W=W, R=R, T=T, MT=MT, n_targets=n_tg)
        yield "admit_scan_preempt", preempt_args(c), dict(depth=c["depth"])
    for S, n_valid, K, n_cands, n_cqs, n_coh, depth, F in SEARCH_SHAPES:
        c = preemption_searches(rng, S=S, n_valid=n_valid, K=K,
                                n_cands=n_cands, n_cqs=n_cqs,
                                n_cohorts=n_coh, depth=depth, F=F)
        yield "minimal_preemptions_batch", search_args(c), dict(
            depth=c["depth"])


# the flat scan's forest layouts: (label, admit_cycle keyword arguments)
FLAT_CASES = [
    # cohorts of five, their heads interleaved in the cycle order
    ("interleaved", dict(n_cqs=60, n_cohorts=12, depth=2, F=3, W=64, R=2,
                         per=5)),
    ("padding", dict(n_cqs=20, n_cohorts=4, depth=3, F=2, W=48, R=2,
                     n_valid=30)),
    ("reserve", dict(n_cqs=12, n_cohorts=3, depth=2, F=2, W=40, R=2,
                     per=4)),
    ("one_forest", dict(n_cqs=40, n_cohorts=6, depth=3, F=3, W=64, R=2,
                        roots=1)),
    ("depth_17", dict(n_cqs=6, n_cohorts=16, depth=2, F=3, W=24, R=2,
                      chain=True)),
    ("F_65", dict(n_cqs=8, n_cohorts=3, depth=3, F=65, W=16, R=5)),
]
# one forest whose working set is past a block's shared memory, and the
# widths past the warps' column rows in shared memory (card)
FLAT_CARD_CASES = [
    ("over_smem", dict(n_cqs=18000, n_cohorts=200, depth=3, F=3, W=64,
                       R=2, roots=1)),
    ("F_1025", dict(n_cqs=6, n_cohorts=3, depth=3, F=1025, W=16, R=3)),
    # forests of one CQ under one cohort: their rows fit a block, eight
    # column rows of 7,257 ints do not
    ("F_7257", dict(n_cqs=4, n_cohorts=4, depth=2, F=7257, W=16, R=3,
                    per=1)),
]


def flat_scan_cases(seed: int = 0, card: bool = False):
    """Yield (label, admit_scan's numpy arrays, keyword arguments,
    (forest_of_node, n_forests)) over ``FLAT_CASES`` (and with ``card``
    ``FLAT_CARD_CASES``): the layouts the forest-parallel flat scan
    groups its heads by.  "reserve" makes every head without a fit a
    reserve head; "padding" leaves 18 of 48 heads without a CQ."""
    rng = np.random.default_rng(seed)
    for label, kw in FLAT_CASES + (FLAT_CARD_CASES if card else []):
        c = admit_cycle(rng, **kw)
        if label == "reserve":
            valid = c["wl_cq"] >= 0
            c["res_mask"] = ~c["fit_mask"] & valid
            F = c["usage0"].shape[1]
            c["res_fr"], c["res_amt"] = _pairs(rng, len(valid), kw["R"], F,
                                               c["res_mask"])
            c["res_borrows"] = (rng.random(len(valid)) < 0.5) & c["res_mask"]
        yield (label, admit_args(c), dict(depth=c["depth"]),
               (c["forest_of_node"], c["n_forests"]))


# ----------------------------------------------------------------------
# The fused burst (ops/burst.py burst_cycles)
# ----------------------------------------------------------------------

def burst_synthetic(rng: np.random.Generator, *, C: int = 12, M: int = 16,
                    R: int = 1, S: int = 1, K: int = 8, per: int = 4,
                    runtime: int = 3, ties: bool = False,
                    deep: int = 0):
    """A seeded synthetic burst window: ``(args, kw)`` in
    ``ops.burst.ARG_NAMES`` order.  CQs sit in cohorts of ``per`` (one
    cohort node each; ``deep`` adds that many levels above them, a node
    above every two of the level below, a depth the preemption envelope
    excludes), with pending and admitted
    rows, usage consistent with the admitted rows, low nominal quota so
    heads need preemption, finishes and external release / unpark events
    inside the window, a few heads outside the vectorized coverage, and
    StrictFIFO CQs.  ``ties`` gives candidates equal ordering keys and
    heads equal cycle ranks, so only the stable sorts' index order
    separates them."""
    from .ops.burst import build_candidate_tables, build_members
    from .ops.cycle import available_all_np
    sizes = [-(-C // per)]
    for _ in range(int(deep)):
        sizes.append(-(-sizes[-1] // 2))
    starts = C + np.concatenate([[0], np.cumsum(sizes)])
    N = int(starts[-1])
    F = S * R
    parent = np.full(N, -1, dtype=np.int32)
    parent[:C] = C + np.arange(C) // per
    for lvl in range(len(sizes) - 1):
        parent[starts[lvl]:starts[lvl + 1]] = (
            starts[lvl + 1] + np.arange(sizes[lvl]) // 2)
    level = np.zeros(N, dtype=np.int32)
    for n in range(N):
        p = parent[n]
        while p >= 0:
            level[n] += 1
            p = parent[p]
    depth = int(level.max()) + 1
    root = np.arange(N)
    for _ in range(depth):
        root = np.where(parent[root] >= 0, parent[root], root)
    _, forest_of_cq = np.unique(root[:C], return_inverse=True)
    forest_of_cq = forest_of_cq.astype(np.int32)
    G = int(forest_of_cq.max()) + 1
    L = int(np.bincount(forest_of_cq).max())
    members = build_members(forest_of_cq, G, L)
    KC = min(4096, ((L * M + 31) // 32) * 32)
    cand_rows, cand_lmem, self_lmem = build_candidate_tables(
        forest_of_cq, members, M, KC)

    unit = 1000
    guaranteed = np.zeros((N, F), np.int32)
    nominal = rng.integers(2, 6, (C, F)).astype(np.int32) * unit
    guaranteed[:C] = nominal
    has_blim = np.zeros((N, F), bool)
    has_blim[:C] = rng.random((C, F)) < 0.5
    blim = rng.integers(1, 8, (C, F)).astype(np.int32) * unit
    borrow_cap = np.full((N, F), I32_LIMIT, np.int32)
    borrow_cap[:C] = np.where(has_blim[:C], blim, I32_LIMIT)
    subtree = np.zeros((N, F), np.int64)
    subtree[:C] = nominal
    for n in np.argsort(-level, kind="stable"):
        if parent[n] >= 0:
            subtree[parent[n]] += subtree[n]
    subtree = subtree.astype(np.int32)
    npb = np.where(has_blim[:C], nominal + blim, I32_LIMIT).astype(np.int32)
    slot_fr = (np.arange(S)[:, None] * R + np.arange(R)[None, :])
    slot_fr = np.broadcast_to(slot_fr, (C, S, R)).astype(np.int32).copy()
    slot_valid = np.ones((C, S), bool)
    potential0 = np.minimum(available_all_np(
        np.zeros((N, F), np.int64), subtree, guaranteed, borrow_cap,
        has_blim, parent, depth), I32_LIMIT).astype(np.int32)

    n_rows = rng.integers(M // 2, M + 1, C)
    live = np.arange(M)[None, :] < n_rows[:, None]
    wl_req = (rng.integers(1, 5, (C, M, R)) * unit // 2).astype(np.int32)
    wl_req[~live] = 0
    wl_rank = np.where(live, np.argsort(rng.random((C, M)), axis=1),
                       INF_I32).astype(np.int32)
    wl_cycle_rank = rng.permutation(C * M).reshape(C, M).astype(np.int32)
    wl_prio = np.where(live, rng.choice([0, 50, 100, 200], (C, M)),
                       0).astype(np.int32)
    wl_uidrank = rng.permutation(C * M).reshape(C, M).astype(np.int32)
    huge = live & (rng.random((C, M)) < 0.05)
    wl_req[huge] = 50 * unit                    # never fits: parks
    # admitted rows fill each CQ to 0.6-1.6x its nominal quota
    adm = np.zeros((C, M), bool)
    for c in range(C):
        room = int(nominal[c, 0] * rng.uniform(0.6, 1.6))
        for m in rng.permutation(int(n_rows[c])):
            q = int(wl_req[c, m, 0])
            if 0 < q <= room and not huge[c, m] and rng.random() < 0.6:
                adm[c, m] = True
                room -= q
    adm_seq = np.where(adm, rng.integers(1, 40, (C, M)), 0).astype(np.int32)
    adm_usage = np.zeros((C, M, F), np.int32)
    adm_uses = np.zeros((C, M, F), bool)
    adm_usage[:, :, :R] = np.where(adm[:, :, None], wl_req, 0)
    adm_uses[:, :, :R] = adm[:, :, None] & (wl_req > 0)
    u_cq = adm_usage.sum(1, dtype=np.int64).astype(np.int32)
    parked = live & ~adm & (rng.random((C, M)) < 0.15)
    elig = live & ~adm & ~parked
    resume = np.where(rng.random((C, M)) < 0.2,
                      rng.integers(0, S, (C, M)), 0).astype(np.int32)
    death = np.where(adm & (rng.random((C, M)) < 0.3),
                     rng.integers(0, K, (C, M)), INF_I32).astype(np.int32)
    vec_ok = live & (rng.random((C, M)) < 0.97)
    if ties:
        # equal candidate keys (priority, reservation seq, uid) and equal
        # head cycle ranks inside every forest
        wl_prio[:] = np.where(live, 0, 0)
        wl_prio[np.arange(C), 0] = 100
        adm_seq[adm] = 7
        wl_uidrank[:] = 3
        wl_cycle_rank[:] = np.arange(M)[None, :]
    ext_release = np.zeros((K, C, F), np.int32)
    hits = rng.random((K, C)) < 0.05
    ext_release[hits] = unit // 2
    ext_unpark = rng.random((K, G)) < 0.1

    cq_flags = [rng.random(C) < p for p in (0.3, 0.5, 0.5, 0.2)]
    preempt_ok = np.ones(C, bool) if not deep else np.zeros(C, bool)
    args = (wl_req, wl_rank, wl_cycle_rank, wl_prio, wl_uidrank, vec_ok,
            elig, parked, resume, adm, adm_seq, adm_usage, adm_uses, death,
            np.int32(45), u_cq, potential0, subtree, guaranteed, borrow_cap,
            has_blim, parent, level, nominal, npb, slot_fr, slot_valid,
            cq_flags[0], cq_flags[1], cq_flags[2], forest_of_cq, cq_flags[3],
            np.ones(C, bool), np.ones(C, bool), rng.random(C) < 0.3,
            preempt_ok, members, cand_rows, cand_lmem, self_lmem,
            ext_release, ext_unpark)
    kw = dict(K=K, depth=depth, L=L, S=S, KC=KC, n_levels=depth, G=G,
              runtime=runtime)
    return args, kw


INF_I32 = 2**31 - 1


def burst_cases(seed: int = 0):
    """The standard burst sweep: ``(label, args, kw)`` windows of
    ``burst_synthetic`` at several shapes (multi-flavor, two resources,
    runtime 0, ties, a deeper forest) and the probe shape of
    ``ops.burst.burst_probe``."""
    from .ops.burst import burst_probe_args
    rng = np.random.default_rng(seed)
    shapes = [
        ("base", dict()),
        ("flavors", dict(S=2, M=8, C=10, per=5)),
        ("two-res", dict(R=2, M=32, C=8, per=4, runtime=0)),
        ("ties", dict(ties=True, C=8, per=4)),
        ("deep", dict(deep=True, C=16, per=3, M=8)),
        ("wide", dict(C=30, per=6, M=64, K=4)),
    ]
    for label, kw in shapes:
        args, size = burst_synthetic(rng, **kw)
        yield label, args, size
    args, size = burst_probe_args(10, 16, 1, 8)
    yield "probe", args, size


def burst_one_forest(seed: int = 0, C: int = 40, M: int = 16, K: int = 8):
    """A burst window whose C CQs all sit under one cohort: one forest,
    the worst case for a block per forest."""
    return burst_synthetic(np.random.default_rng(seed), C=C, per=C, M=M,
                           K=K)


def shape_cases(seed: int = 0, card: bool = False):
    """The shapes past the CUDA launchers' old limits: ``(kernel name,
    positional numpy arrays, keyword arguments)`` with a cohort chain 17
    levels deep for every kernel that walks chains (the admit scans, the
    batched search, the burst, ``kq_cq_avail``, ``drs_components``,
    ``fs_admit_scan``), and ``fs_admit_scan`` at F = 65 and at F = 72
    (8 flavors x 9 resources).  ``card`` adds the shapes only the card
    runs at size: ``kq_cq_avail`` past its staged route (N = 13,000),
    ``admit_scan`` at F = 1,025 and ``admit_scan_forests`` over one
    forest of 40,000 heads."""
    rng = np.random.default_rng(seed)
    deep = dict(n_cqs=6, n_cohorts=16, depth=2, chain=True)
    c = admit_cycle(rng, F=3, W=24, R=2, **deep)
    yield "admit_scan", admit_args(c), dict(depth=c["depth"])
    yield "admit_scan_forests", forest_args(c), dict(
        depth=c["depth"], n_forests=c["n_forests"],
        max_forest_wl=c["max_forest_wl"])
    c = preempt_cycle(rng, F=3, W=24, R=2, T=64, MT=4, n_targets=12, **deep)
    yield "admit_scan_preempt", preempt_args(c), dict(depth=c["depth"])
    c = preemption_searches(rng, S=8, K=16, n_cands=12, F=2, **deep)
    yield "minimal_preemptions_batch", search_args(c), dict(depth=c["depth"])
    args, kw = burst_synthetic(rng, C=8, per=4, M=8, deep=15)
    yield "burst_cycles", args, kw
    c = solve_cycle_planes(rng, S=2, R=2, F=4, W=32, **deep)
    yield "kq_cq_avail", tuple(c[k] for k in SOLVE_ARGS[:6]), dict(
        n_cqs=c["nominal_cq"].shape[0], depth=c["depth"])
    args, kw = drs_case(rng, n_cqs=6, n_cohorts=16, depth=2, F=3, R=2,
                        wl_req=True, chain=True)
    yield "drs_components", args, kw
    for n_cqs, n_coh, F, R, chain in ((8, 3, 65, 5, False),
                                      (10, 4, 72, 9, False),
                                      (6, 16, 72, 9, True)):
        c = fs_cycle(rng, n_cqs=n_cqs, n_cohorts=n_coh, depth=3, F=F, R=R,
                     W=16, chain=chain)
        yield "fs_admit_scan", fs_args(c), fs_kw(c)
    if not card:
        return
    yield ("kq_cq_avail", *avail_case(rng, *AVAIL_CARD_SHAPES[-1]))
    c = admit_cycle(rng, n_cqs=6, n_cohorts=3, depth=3, F=1025, W=16, R=3)
    yield "admit_scan", admit_args(c), dict(depth=c["depth"])
    c = admit_cycle(rng, n_cqs=20, n_cohorts=1, depth=2, F=2, W=40_000,
                    R=2, chain=True)
    # room at the cohort for about half of the heads: the scan admits
    # until the root runs out, then decides the rest against a full root
    c["subtree"][-1] = 100_000
    c["usage0"][-1] = 0
    c["has_blim"][:] = False
    yield "admit_scan_forests", forest_args(c), dict(
        depth=c["depth"], n_forests=c["n_forests"],
        max_forest_wl=c["max_forest_wl"])


# ----------------------------------------------------------------------
# Fair sharing (ops/fs_scan.py fs_admit_scan, ops/fairsharing_kernel.py
# drs_components)
# ----------------------------------------------------------------------

FS_WEIGHTS = (0, 500, 1000, 2000, 3000, 4000)


def _levels_and_order(rng, parent: np.ndarray):
    """node_level [N] (roots 0) and child_order [N] (a distinct rank
    among each parent's children, shuffled)."""
    N = len(parent)
    level = np.zeros(N, dtype=np.int32)
    for n in range(N):
        p = parent[n]
        while p >= 0:
            level[n] += 1
            p = parent[p]
    child_order = np.zeros(N, dtype=np.int32)
    for p in np.unique(parent[parent >= 0]):
        kids = np.nonzero(parent == p)[0]
        child_order[kids] = rng.permutation(len(kids))
    return level, child_order


def fs_cycle(rng: np.random.Generator, *, n_cqs: int = 8, n_cohorts: int = 3,
             depth: int = 2, F: int = 2, R: int = 1, W: int = 16,
             n_valid: int | None = None, weights=FS_WEIGHTS,
             zero_lend: float = 0.2, ties: bool = False,
             chain: bool = False, roots: int = 0, per: int = 0) -> dict:
    """Inputs of fs_admit_scan (``ops.fs_scan.FS_ARGS`` plus ``depth`` and
    ``n_levels``) as numpy arrays: a cohort forest of up to ``depth``
    levels, usage that borrows above subtree quota, lendable capacity
    that is zero at roots and at a ``zero_lend`` share of the other nodes
    (the floor-division case), one head per CQ in the first ``n_valid``
    rows and padding after, NoFit heads, and with ``ties`` equal
    priorities and timestamp ranks (``chain``, ``roots`` and ``per`` as
    ``forest``), with the kernel's ``n_forests`` and ``max_forest``."""
    parent, forest_of, n_forests, true_depth = forest(
        rng, n_cqs, n_cohorts, depth, chain, roots, per)
    N = n_cqs + n_cohorts
    q = quota_planes(rng, N, F)
    sq_mask = rng.random((N, F)) < 0.85
    fr_to_r = np.arange(F) % R
    rng.shuffle(fr_to_r)
    onehot = (fr_to_r[:, None] == np.arange(R)[None, :]).astype(np.int32)
    lendable_r = rng.integers(1, 80, (N, R)).astype(np.int32)
    lendable_r[rng.random((N, R)) < zero_lend] = 0
    lendable_r[parent < 0] = 0
    level, child_order = _levels_and_order(rng, parent)
    w = np.asarray(weights, dtype=np.int32)
    n_valid = min(W, n_cqs) if n_valid is None else n_valid
    wl_cq = np.full(W, -1, dtype=np.int32)
    wl_cq[:n_valid] = rng.choice(n_cqs, n_valid, replace=False)
    valid = wl_cq >= 0
    u_e = np.where(valid[:, None], rng.integers(0, 25, (W, F)),
                   0).astype(np.int32)
    hi = 3 if ties else 1000
    return dict(
        q, sq_mask=sq_mask, parent=parent, node_level=level,
        weights=w[rng.integers(0, len(w), N)], lendable_r=lendable_r,
        onehot=onehot, child_order=child_order, wl_cq=wl_cq, u_e=u_e,
        nofit=(rng.random(W) < 0.2) & valid,
        prio=rng.integers(0, hi, W).astype(np.int32) * 10,
        ts_rank=rng.integers(0, hi, W).astype(np.int32), valid=valid,
        forest_of_node=forest_of, depth=max(depth, true_depth),
        n_levels=int(level.max()) + 1, n_forests=n_forests,
        max_forest=int(np.bincount(forest_of).max()))


def fs_args(case: dict) -> tuple:
    """fs_admit_scan's positional arrays (``ops.fs_scan.FS_ARGS``)."""
    from .ops.fs_scan import FS_ARGS
    return tuple(case[k] for k in FS_ARGS)


def fs_kw(case: dict) -> dict:
    """fs_admit_scan's keywords: ``depth``, ``n_levels``, and the CUDA
    kernel's grid and block sizing (``n_forests``, ``max_forest``)."""
    return {k: case[k] for k in ("depth", "n_levels", "n_forests",
                                 "max_forest")}


def fs_floor_case() -> dict:
    """Two CQs of one cohort, where only floor division orders them: A
    borrows a resource that has no lendable capacity (ratio -1) at weight
    4,000, so its DRS is -1000 // 4000 = -1 (truncation: 0); B does not
    borrow (DRS 0) and has the higher priority.  Floor: A wins round 0;
    truncation: a tie on DRS, and B would win on priority."""
    parent = np.array([2, 2, -1], dtype=np.int32)
    z = np.zeros((3, 1), dtype=np.int32)
    usage0 = np.array([[5], [0], [5]], dtype=np.int32)
    subtree = np.array([[4], [10], [20]], dtype=np.int32)
    return dict(
        usage0=usage0, subtree=subtree, sq_mask=np.ones((3, 1), bool),
        guaranteed=z.copy(), borrow_cap=np.full((3, 1), I32_LIMIT, np.int32),
        has_blim=np.zeros((3, 1), bool), parent=parent,
        node_level=np.array([1, 1, 0], np.int32),
        weights=np.array([4000, 3000, 1000], np.int32),
        lendable_r=np.zeros((3, 1), np.int32),
        onehot=np.ones((1, 1), np.int32),
        child_order=np.array([0, 1, 0], np.int32),
        wl_cq=np.array([1, 0, -1, -1], np.int32),
        u_e=np.array([[1], [1], [0], [0]], np.int32),
        nofit=np.zeros(4, bool),
        prio=np.array([100, 0, 0, 0], np.int32),
        ts_rank=np.array([0, 1, 0, 0], np.int32),
        valid=np.array([True, True, False, False]),
        forest_of_node=np.zeros(3, np.int32), depth=2, n_levels=2,
        n_forests=1, max_forest=3)


# (n_cqs, n_cohorts, depth, F, R, W, n_valid, ties, weights, zero_lend
# [, fs_cycle's forest keywords])
FS_SHAPES = [
    (6, 2, 2, 1, 1, 8, 6, False, FS_WEIGHTS, 0.2),         # flat
    (8, 3, 2, 2, 2, 16, 7, True, FS_WEIGHTS, 0.2),         # ties, padding
    (10, 4, 3, 3, 2, 16, 10, False, FS_WEIGHTS, 0.2),      # nested
    (12, 4, 3, 1, 1, 16, 12, True, (0, 1000), 0.0),        # MAX_DRS
    (9, 3, 2, 1, 1, 16, 9, False, (3000, 4000), 1.0),      # floor division
    (10, 4, 3, 2, 2, 16, 10, True, (3000, 4000), 0.5),
    (60, 20, 3, 2, 1, 64, 50, False, FS_WEIGHTS, 0.2),     # N > 64
    (60, 20, 2, 2, 2, 64, 60, True, FS_WEIGHTS, 0.3),
    # the kernel's block per forest: one forest holding every CQ (cohorts
    # nested under one root), many forests of three nodes, and more
    # forests (~160: 100 cohorts and the parentless CQs) than the card's
    # 132 SMs
    (40, 12, 4, 2, 2, 48, 40, True, FS_WEIGHTS, 0.2, dict(roots=1)),
    (60, 30, 2, 1, 1, 64, 60, False, FS_WEIGHTS, 0.2, dict(per=2)),
    (400, 100, 2, 1, 1, 416, 400, True, FS_WEIGHTS, 0.2),
    (1000, 200, 2, 1, 1, 1024, 1000, False, FS_WEIGHTS, 0.2),  # north star
]


def fs_shape_cycle(rng: np.random.Generator, shape: tuple) -> dict:
    """``fs_cycle`` of one ``FS_SHAPES`` row."""
    n_cqs, n_coh, depth, F, R, W, n_valid, ties, w, zl, *extra = shape
    return fs_cycle(rng, n_cqs=n_cqs, n_cohorts=n_coh, depth=depth, F=F,
                    R=R, W=W, n_valid=n_valid, ties=ties, weights=w,
                    zero_lend=zl, **(extra[0] if extra else {}))


# (n_cqs, n_cohorts, depth, F, R, with wl_req)
DRS_SHAPES = [
    (6, 3, 2, 1, 1, False),
    (8, 4, 3, 3, 2, True),
    (60, 20, 3, 4, 2, False),
    (60, 20, 3, 2, 2, True),
    (1000, 200, 2, 1, 1, False),
]


def drs_case(rng: np.random.Generator, *, n_cqs: int, n_cohorts: int,
             depth: int, F: int, R: int, wl_req: bool,
             chain: bool = False) -> tuple:
    """(positional arrays, keywords) of drs_components (``chain`` as
    ``forest``)."""
    parent, _, _, true_depth = forest(rng, n_cqs, n_cohorts, depth, chain)
    N = n_cqs + n_cohorts
    q = quota_planes(rng, N, F)
    fr = (np.arange(F) % R).astype(np.int32)
    rng.shuffle(fr)
    args = (q["usage0"], q["subtree"], q["guaranteed"], q["borrow_cap"],
            q["has_blim"], parent, fr)
    if wl_req:
        args += (rng.integers(0, 30, (N, F)).astype(np.int32),)
    return args, dict(n_resources=R, depth=max(depth, true_depth))


def fs_cases(seed: int = 0):
    """The fair-sharing sweep a CUDA kernel is held to against its plain
    version: ``(name, positional arrays, keywords)`` for fs_admit_scan
    over ``FS_SHAPES`` plus ``fs_floor_case``, and for drs_components over
    ``DRS_SHAPES``."""
    rng = np.random.default_rng(seed)
    for shape in FS_SHAPES:
        c = fs_shape_cycle(rng, shape)
        yield "fs_admit_scan", fs_args(c), fs_kw(c)
    c = fs_floor_case()
    yield "fs_admit_scan", fs_args(c), fs_kw(c)
    for n_cqs, n_coh, depth, F, R, wl_req in DRS_SHAPES:
        args, kw = drs_case(rng, n_cqs=n_cqs, n_cohorts=n_coh, depth=depth,
                            F=F, R=R, wl_req=wl_req)
        yield "drs_components", args, kw


def fs_borrowing_cluster(t, d, clock, nested: bool = False,
                         cycles: int = 3) -> None:
    """Populate a ``Driver(fair_sharing=True)`` ``d`` of either package
    (``t`` its api.types module, ``clock`` its settable clock) with a
    small fair-sharing cluster that borrows — two cohorts of three CQs
    with weights 0.5-4 (one zero), lending limits, cpu and memory,
    optionally under a common parent cohort — submit 40 seeded workloads
    and run ``cycles`` cycles."""
    d.apply_resource_flavor(t.ResourceFlavor(name="default"))
    if nested:
        for c in range(2):
            d.apply_cohort(t.Cohort(name=f"co-{c}", parent_name="org"))
    weights = (0.5, 1.0, 2.0, 0.0, 3.0, 4.0)
    for c in range(2):
        for q in range(3):
            d.apply_cluster_queue(t.ClusterQueue(
                name=f"cq-{c}-{q}", cohort=f"co-{c}",
                fair_sharing=t.FairSharing(weight=weights[c * 3 + q]),
                resource_groups=[t.ResourceGroup(
                    covered_resources=["cpu", "memory"],
                    flavors=[t.FlavorQuotas(name="default", resources={
                        "cpu": t.ResourceQuota(
                            nominal=2000, borrowing_limit=6000,
                            lending_limit=1000 if q == 1 else None),
                        "memory": t.ResourceQuota(nominal=4000)})])]))
            d.apply_local_queue(t.LocalQueue(name=f"lq-{c}-{q}",
                                             cluster_queue=f"cq-{c}-{q}"))
    rng = np.random.default_rng(7)
    for k in range(40):
        c, q = int(rng.integers(2)), int(rng.integers(3))
        d.create_workload(t.Workload(
            name=f"w-{k}", queue_name=f"lq-{c}-{q}",
            priority=int(rng.choice([0, 10])), creation_time=float(k + 1),
            pod_sets=[t.PodSet(name="main", count=1, requests={
                "cpu": int(rng.choice([500, 1500, 2500])),
                "memory": int(rng.choice([500, 1000]))})]))
    for _ in range(cycles):
        clock.t += 1.0
        d.schedule_once()


# ----------------------------------------------------------------------
# Topology-aware scheduling (ops/tas_kernel.py: fill_counts,
# best_fit_descend, split_across_roots)
# ----------------------------------------------------------------------

TAS_LEVELS = ("block", "rack", "host")
# split_across_roots (profile, descend_profile): the three profiles, and
# the Mixed gate's unconstrained variant (roots least-free, descent
# best-fit)
TAS_SPLITS = (("bestfit", "bestfit"), ("mostfree", "mostfree"),
              ("leastfree", "leastfree"), ("leastfree", "bestfit"))
# per-pod requests of the sweep: two shapes, nothing requested, and a
# resource no leaf has (the snapshot then zeroes every leaf's free)
TAS_REQUESTS = ({"cpu": 2000}, {"cpu": 1000, "nvidia.com/gpu": 1}, {},
                {"cpu": 1000, "example.com/fpga": 1})


def tas_snapshot(rng: np.random.Generator, *, n_levels: int = 3,
                 n_roots: int = 3, fanout: int = 4, ties: bool = False,
                 used: float = 0.2):
    """A seeded ``TASFlavorSnapshot`` (this package's) of ``n_levels``
    (1-3) levels (the last of ``TAS_LEVELS``): ``n_roots`` roots, every inner
    domain with 1..``fanout`` children (ragged), leaves with cpu, GPUs
    and pods drawn from sets that hold 0 (some leaves lack a resource
    altogether), and a ``used`` share of leaves charged above their
    capacity in part (free clipped at 0).  With ``ties`` every leaf has
    the same capacity."""
    from .cache.tas_cache import NodeInfo
    from .cache.tas_snapshot import TASFlavorSnapshot
    levels = list(TAS_LEVELS[3 - n_levels:])
    nodes = []
    usage = {}

    def grow(prefix: tuple, depth: int) -> None:
        if depth == n_levels:
            cap = ({"cpu": 8000, "nvidia.com/gpu": 8, "pods": 16} if ties
                   else {"cpu": int(rng.choice([0, 4000, 8000, 16000])),
                         "nvidia.com/gpu": int(rng.choice([0, 4, 8])),
                         "pods": int(rng.choice([8, 16]))})
            if not ties and rng.random() < 0.15:
                del cap["nvidia.com/gpu"]
            nodes.append(NodeInfo(name="n-" + "-".join(prefix),
                                  labels=dict(zip(levels, prefix)),
                                  capacity=cap))
            if not ties and rng.random() < used:
                usage[prefix] = {"cpu": int(rng.choice([1000, 20000])),
                                 "nvidia.com/gpu": int(rng.integers(1, 9))}
            return
        n = n_roots if depth == 0 else int(rng.integers(1, fanout + 1))
        for i in range(n):
            name = f"{levels[depth]}{i}"
            grow(prefix + (f"{prefix[-1]}.{name}" if prefix else name,),
                 depth + 1)

    grow((), 0)
    return TASFlavorSnapshot.build("tas-flavor", levels, nodes, usage)


def tas_query_inputs(packed, per_pod: dict) -> tuple:
    """(leaf_free, per_pod vector) of one query as
    ``TASFlavorSnapshot._find_device`` builds them (no assumed usage): a
    requested resource that no leaf has zeroes every leaf's free."""
    r_index = {r: i for i, r in enumerate(packed.resource_names)}
    vec = np.zeros(max(1, len(packed.resource_names)), dtype=np.int32)
    leaf_free = packed.leaf_free
    for r, v in per_pod.items():
        if r in r_index:
            vec[r_index[r]] = v
        else:
            leaf_free = np.zeros_like(packed.leaf_free)
    return leaf_free, vec


def tas_sweep(leaf_free, per_pod, parents, level_sizes, counts):
    """(name, positional arrays, keywords) of every TAS function on one
    query's inputs: fill_counts, best_fit_descend at every level under
    every profile, split_across_roots under ``TAS_SPLITS``, at each of
    ``counts``."""
    from .ops.tas_kernel import PROFILES
    parents = tuple(parents)
    sizes = tuple(int(s) for s in level_sizes)
    yield "fill_counts", (leaf_free, per_pod, parents), dict(
        level_sizes=sizes)
    for count in counts:
        for level in range(len(sizes)):
            for profile in PROFILES:
                yield "best_fit_descend", (
                    leaf_free, per_pod, parents, int(count)), dict(
                        level_sizes=sizes, level=level, profile=profile)
        for profile, descend in TAS_SPLITS:
            yield "split_across_roots", (
                leaf_free, per_pod, parents, int(count)), dict(
                    level_sizes=sizes, profile=profile,
                    descend_profile=descend)


def _tas_counts(leaf_free, per_pod, parents, sizes) -> list:
    """0, 1, a count that fits some domains, the largest leaf state, the
    total and one above it."""
    import torch
    from .ops.tas_kernel import fill_counts_plain
    states = fill_counts_plain(
        torch.from_numpy(leaf_free), torch.from_numpy(per_pod),
        tuple(torch.from_numpy(p) for p in parents), level_sizes=sizes)
    total = int(states[0].long().sum())
    top = int(states[-1].max())
    return sorted({0, 1, max(1, top // 2 + 1), top,
                   min(total, 2**31 - 2), min(total, 2**31 - 2) + 1})


def tas_wrap_case() -> tuple:
    """Two roots whose sums wrap int32: leaves of 2**31 - 1 free at one
    pod each, so root 0 sums to 3 and root 1 to -2**31 + 2 (XLA wraps).
    Returns (leaf_free, per_pod, parents, level_sizes)."""
    big = 2**31 - 1
    leaf_free = np.array([[big], [big], [5], [big], [3], [0]], np.int32)
    return (leaf_free, np.ones(1, np.int32),
            (np.array([0, 0, 0, 1, 1, 1], np.int32),), (2, 6))


def tas_flat_case(rng: np.random.Generator, n: int) -> tuple:
    """One level of ``n`` roots (a hostname-only topology) with few
    distinct capacities (many ties) and a per-pod request of the largest
    int32 in a second column: (leaf_free, per_pod, parents, sizes)."""
    leaf_free = np.stack([rng.choice([0, 8, 8, 16], n),
                          rng.choice([0, 2**31 - 1], n)], 1).astype(np.int32)
    return leaf_free, np.array([4, 0], np.int32), (), (n,)


def tas_shuffled(rng: np.random.Generator, leaf_free, parents, sizes):
    """The same tree with the domains of every level below the roots in
    a random order, so each level's ``parents`` is not monotone (the
    kernels' sort route): (leaf_free, parents)."""
    parents = [np.asarray(p) for p in parents]
    inv_prev = np.arange(sizes[0])
    for d in range(1, len(sizes)):
        perm = rng.permutation(sizes[d])      # new index k: old perm[k]
        parents[d - 1] = inv_prev[parents[d - 1][perm]].astype(np.int32)
        inv_prev = np.argsort(perm)
        if d == len(sizes) - 1:
            leaf_free = leaf_free[perm]
    return np.ascontiguousarray(leaf_free), tuple(parents)


def tas_runs_case(rng: np.random.Generator, runs: tuple) -> tuple:
    """Leaves under parents in runs of the given lengths, below one or
    two levels: ``runs[0]`` the root level's runs of the middle level
    (or None for two levels), ``runs[-1]`` the runs of leaves.  Leaves
    hold few distinct capacities (ties), some none.  (leaf_free,
    per_pod, parents, sizes)."""
    levels = [r for r in runs if r is not None]
    parents = tuple(np.repeat(np.arange(len(r)), r).astype(np.int32)
                    for r in levels)
    sizes = (len(levels[0]),) + tuple(int(sum(r)) for r in levels)
    n = sizes[-1]
    leaf_free = np.stack([rng.choice([0, 4000, 8000, 8000, 16000], n),
                          rng.choice([0, 4, 8, 8], n)], 1).astype(np.int32)
    return leaf_free, np.array([2000, 1], np.int32), parents, sizes


# (n_levels, n_roots, fanout, ties) by part name
TAS_SHAPES = {
    "three_levels": (3, 3, 4, False),
    "ties": (3, 2, 3, True),      # id order decides (reversed: LeastFree)
    "two_levels": (2, 4, 5, False),
    "one_level": (1, 6, 1, False),
    "wide": (3, 4, 6, False),
    "tas4k": (3, 8, 32, False),   # the tas-4k cluster's shape, ragged
    "shuffled": (3, 3, 5, False),
}
# every part in the order of their generators' seeds; "tas4k" is held
# out of the CPU sweep (TAS_PARTS)
TAS_ALL = ("three_levels", "ties", "two_levels", "one_level", "wide",
           "wrap", "flat", "tas4k", "shuffled", "wide_runs")
TAS_PARTS = tuple(p for p in TAS_ALL if p != "tas4k")
# runs of leaves past the warp route's 32 (33-128), beside runs it takes,
# under two and three levels
TAS_WIDE_RUNS = ((None, (33, 1, 128, 16)), ((2, 3), (40, 32, 64, 7, 100)))


def tas_cases(seed: int = 0, parts=TAS_PARTS, *, flat: int = 80):
    """The TAS sweep a CUDA kernel is held to against its plain version,
    and the plain version against the JAX programs: ``(name, positional
    arrays, keywords)`` over the named ``parts`` — seeded snapshots of
    ``TAS_SHAPES`` (1-3 levels, ragged, zero capacities, a resource no
    leaf has) under every request of ``TAS_REQUESTS``, the wrapping case
    (``wrap``), a flat level of ``flat`` roots (``flat``), a snapshot
    whose levels are shuffled out of id order (``shuffled``: parents not
    monotone) and runs of 33-128 children (``wide_runs``).  Each part
    draws from its own generator, so any subset gives the same cases."""
    from .ops.tas_kernel import pack_tas
    for j, part in enumerate(TAS_ALL):
        if part not in parts:
            continue
        rng = np.random.default_rng([seed, j])
        if part == "wide_runs":
            for runs in TAS_WIDE_RUNS:
                leaf_free, per_pod, parents, sizes = tas_runs_case(rng, runs)
                yield from tas_sweep(leaf_free, per_pod, parents, sizes,
                                     _tas_counts(leaf_free, per_pod,
                                                 parents, sizes))
            continue
        if part == "wrap":
            leaf_free, per_pod, parents, sizes = tas_wrap_case()
            yield from tas_sweep(leaf_free, per_pod, parents, sizes,
                                 (0, 1, 2, 3, 4, 5, 6))
            continue
        if part == "flat":
            leaf_free, per_pod, parents, sizes = tas_flat_case(rng, flat)
            yield from tas_sweep(leaf_free, per_pod, parents, sizes,
                                 _tas_counts(leaf_free, per_pod, parents,
                                             sizes))
            continue
        n_levels, n_roots, fanout, ties = TAS_SHAPES[part]
        packed = pack_tas(tas_snapshot(rng, n_levels=n_levels,
                                       n_roots=n_roots, fanout=fanout,
                                       ties=ties))
        sizes = tuple(packed.level_sizes)
        parents = packed.parents
        for request in TAS_REQUESTS:
            leaf_free, per_pod = tas_query_inputs(packed, request)
            if part == "shuffled":
                leaf_free, parents = tas_shuffled(
                    np.random.default_rng([seed, j, 1]), leaf_free,
                    packed.parents, sizes)
            counts = _tas_counts(leaf_free, per_pod, parents, sizes)
            yield from tas_sweep(leaf_free, per_pod, parents, sizes, counts)


# ----------------------------------------------------------------------
# The one-call cycle solver (ops/cycle.py solve_cycle)
# ----------------------------------------------------------------------

SOLVE_ARGS = ("usage0", "subtree", "guaranteed", "borrow_cap", "has_blim",
              "parent", "nominal_cq", "slot_fr", "slot_valid",
              "cq_can_preempt_borrow", "wl_cq", "wl_requests",
              "wl_priority", "wl_timestamp")
FUNGIBILITY_ARGS = ("cq_wcb_borrow", "cq_wcp_preempt", "start_slot")
I32_MIN = -2**31


def solve_cycle_planes(rng: np.random.Generator, *, n_cqs: int = 12,
                       n_cohorts: int = 4, depth: int = 3, S: int = 3,
                       R: int = 2, F: int = 6, W: int = 64,
                       n_valid: int | None = None, ties: bool = True,
                       big: bool = True, fungibility: bool = True,
                       chain: bool = False, roots: int = 0) -> dict:
    """The 14 planes of solve_cycle (``SOLVE_ARGS``) plus the optional
    FlavorFungibility planes (``FUNGIBILITY_ARGS``), ``forest_of_node``,
    ``n_forests``, ``max_forest_wl`` and the static ``depth``.

    Slots name -1 (an uncovered resource) and some are invalid; heads
    past ``n_valid`` are padding (``wl_cq = -1``); requests of 0 are not
    needed.  ``ties``: priorities from {0, 5, INT_MIN} and float64
    timestamps 1e9 + k that tie once cast to float32.  ``big``: a few CQ
    usage cells near INT_MAX and requests near 2**30, so ``use + req``
    and the quota recurrences wrap.  ``fungibility``: random
    whenCanBorrow / whenCanPreempt per CQ and resume slots per head.
    ``chain`` and ``roots`` as ``forest``."""
    parent, forest_of, n_forests, true_depth = forest(rng, n_cqs, n_cohorts,
                                                      depth, chain, roots)
    N = n_cqs + n_cohorts
    q = quota_planes(rng, N, F)
    nominal = rng.integers(0, 30, (n_cqs, F)).astype(np.int32)
    slot_fr = rng.integers(0, F, (n_cqs, S, R)).astype(np.int32)
    slot_fr[rng.random((n_cqs, S, R)) < 0.15] = -1
    slot_valid = rng.random((n_cqs, S)) < 0.85
    can_pb = rng.random(n_cqs) < 0.3
    n_valid = W if n_valid is None else n_valid
    wl_cq = np.full(W, -1, dtype=np.int32)
    wl_cq[:n_valid] = rng.integers(0, n_cqs, n_valid)
    req = rng.integers(0, 16, (W, R)).astype(np.int32)
    req[rng.random((W, R)) < 0.2] = 0
    if ties:
        prio = rng.choice(np.array([0, 5, I32_MIN], dtype=np.int64),
                          W).astype(np.int32)
        ts = 1e9 + rng.integers(0, 4, W).astype(np.float64)
    else:
        prio = rng.integers(0, 100, W).astype(np.int32)
        ts = rng.random(W)
    usage = q["usage0"]
    if big:
        cells = rng.random((n_cqs, F)) < 0.1
        usage[:n_cqs][cells] = (2**31 - 1 - rng.integers(
            0, 1000, int(cells.sum()))).astype(np.int32)
        heads = rng.random(W) < 0.1
        req[heads] = rng.integers(2**30, 2**31 - 1,
                                  (int(heads.sum()), R)).astype(np.int32)
    if fungibility:
        wcb = rng.random(n_cqs) < 0.7
        wcp = rng.random(n_cqs) < 0.3
        start = np.where(rng.random(W) < 0.3, rng.integers(0, S + 1, W),
                         0).astype(np.int32)
    else:
        wcb = np.ones(n_cqs, dtype=bool)
        wcp = np.zeros(n_cqs, dtype=bool)
        start = np.zeros(W, dtype=np.int32)
    f_w = forest_of[np.maximum(wl_cq, 0)][wl_cq >= 0]
    mfw = int(np.bincount(f_w, minlength=n_forests).max()) if len(f_w) else 1
    return dict(q, parent=parent, nominal_cq=nominal, slot_fr=slot_fr,
                slot_valid=slot_valid, cq_can_preempt_borrow=can_pb,
                wl_cq=wl_cq, wl_requests=req, wl_priority=prio,
                wl_timestamp=ts, cq_wcb_borrow=wcb, cq_wcp_preempt=wcp,
                start_slot=start, forest_of_node=forest_of,
                n_forests=n_forests, max_forest_wl=mfw + 1,
                depth=max(depth, true_depth))


# kq_cq_avail's cases: (n_cqs, n_cohorts, depth, F, chain); depth 1 (no
# cohort), 2, 3 (nested cohorts), 6 (a chain of 5 cohorts) and 17 (a
# chain of 16: two segments), one to two warps a CQ; ``card`` adds N =
# 12,288 (the widest staged) and N = 13,000 (the global route)
AVAIL_SHAPES = [
    (9, 3, 1, 5, False),
    (40, 8, 2, 12, False),
    (30, 10, 3, 1, False),
    (12, 5, 3, 32, False),
    (7, 4, 3, 33, False),
    (8, 5, 2, 7, True),
    (6, 16, 2, 12, True),
    (5, 16, 2, 40, True),
]
AVAIL_CARD_SHAPES = [
    (12_000, 288, 3, 12, False),
    (12_400, 600, 3, 4, False),
]


def avail_case(rng: np.random.Generator, n_cqs: int, n_cohorts: int,
               depth: int, F: int, chain: bool) -> tuple:
    """kq_cq_avail's arguments on a forest (``forest``) with quota planes
    whose cells are ~5% at the int32 limits, so the recurrences wrap:
    (the six planes of ``SOLVE_ARGS``, keyword arguments)."""
    parent, _, _, true_depth = forest(rng, n_cqs, n_cohorts, depth, chain)
    N = n_cqs + n_cohorts
    q = quota_planes(rng, N, F)
    edges = np.array([I32_MIN, I32_MIN + 3, 2**31 - 8, 2**31 - 1],
                     dtype=np.int64)
    for k in ("usage0", "subtree", "guaranteed", "borrow_cap"):
        cells = rng.random((N, F)) < 0.05
        q[k][cells] = rng.choice(edges, int(cells.sum())).astype(np.int32)
    planes = (q["usage0"], q["subtree"], q["guaranteed"], q["borrow_cap"],
              q["has_blim"], parent)
    return planes, dict(n_cqs=n_cqs, depth=max(depth, true_depth))


def avail_cases(seed: int = 0, card: bool = False):
    """Yield ("kq_cq_avail", numpy arrays, keyword arguments) over
    ``AVAIL_SHAPES`` (and ``AVAIL_CARD_SHAPES`` with ``card``)."""
    rng = np.random.default_rng(seed)
    for shape in AVAIL_SHAPES + (AVAIL_CARD_SHAPES if card else []):
        yield ("kq_cq_avail", *avail_case(rng, *shape))


def solve_args(case: dict, fungibility: bool = False) -> tuple:
    """solve_cycle's positional arrays (with the fungibility planes)."""
    names = SOLVE_ARGS + (FUNGIBILITY_ARGS if fungibility else ())
    return tuple(case[k] for k in names)


def phase1_cases(case: dict):
    """Yield (kernel name, numpy arrays, keyword arguments) for the three
    phase-1 kernels on one solve_cycle case: ``kq_cq_avail`` on its quota
    planes, ``kq_classify_heads`` (with and without the decision pairs)
    on its heads and the CQ availability the plain version gives, and
    ``kq_cycle_order`` on its priorities, float32 timestamps and random
    borrows."""
    import torch

    from .ops.cycle import cq_avail_plain
    quota = tuple(case[k] for k in SOLVE_ARGS[:6])
    C = case["nominal_cq"].shape[0]
    kw = dict(n_cqs=C, depth=case["depth"])
    yield "kq_cq_avail", quota, kw
    avail0, potential0 = (t.numpy() for t in cq_avail_plain(
        *[torch.from_numpy(np.ascontiguousarray(a)) for a in quota], **kw))
    heads = (case["wl_cq"], case["wl_requests"], case["start_slot"],
             case["slot_fr"], case["slot_valid"], case["nominal_cq"],
             case["usage0"], case["subtree"], case["parent"],
             case["cq_can_preempt_borrow"], case["cq_wcb_borrow"],
             case["cq_wcp_preempt"], avail0, potential0)
    for pairs in (False, True):
        yield "kq_classify_heads", heads, dict(pairs=pairs)
    rng = np.random.default_rng(int(case["wl_cq"].shape[0]))
    borrows = rng.random(case["wl_cq"].shape[0]) < 0.5
    yield "kq_cycle_order", (borrows, case["wl_priority"],
                             case["wl_timestamp"].astype(np.float32)), {}


def order_case(rng: np.random.Generator, W: int) -> tuple:
    """kq_cycle_order's inputs at W heads: borrows, priorities with
    INT_MIN and ties, float32 timestamps with ties, -0.0, +0.0 and NaN."""
    borrows = rng.random(W) < 0.5
    prio = rng.choice(np.array([I32_MIN, -1, 0, 7, 2**31 - 1],
                               dtype=np.int64), W).astype(np.int32)
    ts = rng.choice(np.array([-0.0, 0.0, 1.5, np.nan, -np.inf, 1e9],
                             dtype=np.float32), W)
    return borrows, prio, ts


# (n_cqs, n_cohorts, depth, S, R, F, W, n_valid)
SOLVE_SHAPES = [
    (12, 4, 3, 3, 2, 6, 64, 50),         # N <= 64: dense available_at
    (80, 10, 3, 4, 3, 12, 256, 240),     # N > 64
    (1, 1, 2, 1, 1, 1, 2, 2),
    (24, 6, 3, 6, 7, 16, 90, 85),        # S x R = 42: 7 resources a slot
    (40, 8, 3, 4, 3, 12, 37, 33),        # 8 heads a warp, the last 5
    (10, 3, 3, 40, 1, 8, 24, 20),        # S = 40 > 32: the loop route
]
# kq_cycle_order's route boundaries: one warp up to 128 heads, four keys a
# thread up to 4,096, eight at 8,192, sixteen at 16,384, the global route
# past it
ORDER_WIDTHS = (1, 3, 128, 129, 1000, 4096, 4097, 8192, 8193, 10_000,
                16384, 16385)


def solve_cycle_cases(seed: int = 0):
    """Yield (kernel name, numpy arrays, keyword arguments) over the
    standard sweep of the three phase-1 kernels (``phase1_cases`` of each
    ``SOLVE_SHAPES`` case, then ``kq_cycle_order`` at every width of
    ``ORDER_WIDTHS``: the registers route up to 16,384 heads, global
    scratch beyond)."""
    rng = np.random.default_rng(seed)
    for n_cqs, n_coh, depth, S, R, F, W, n_valid in SOLVE_SHAPES:
        yield from phase1_cases(solve_cycle_planes(
            rng, n_cqs=n_cqs, n_cohorts=n_coh, depth=depth, S=S, R=R, F=F,
            W=W, n_valid=n_valid))
    for W in ORDER_WIDTHS:
        yield "kq_cycle_order", order_case(rng, W), {}


# ----------------------------------------------------------------------
# The forest-sharded burst (parallel/sharded.py BurstShardLayout)
# ----------------------------------------------------------------------

def layout_fields(layout, plan) -> dict:
    """Every host field of a ``BurstShardLayout`` of either package on
    ``plan`` as numpy arrays or scalars, by name: the sizes, the LPT's
    cost figures, the permutations, the value-remapped tables, the
    STATIC tier and the whole permuted plan (``plan_arrays``), and the
    permuted scan state and event schedules of the plan's window — so the
    JAX package's layout and the port's can be compared field by field.
    Both packages' plans carry the same ``arrays`` (and
    ``ops.packing.plan_to_torch`` turns either into the port's
    tensors)."""
    a = plan.arrays
    out = {k: getattr(layout, k) for k in (
        "n_shards", "M", "Cs", "Gs", "Ns", "cost_balanced", "shard_cost",
        "cost_ratio", "cq_perm", "cq_pos", "node_perm", "forest_perm")}
    for k, v in layout._static.items():
        out[f"static.{k}"] = v
    for k, v in layout.static_arrays(plan).items():
        out[f"static_arrays.{k}"] = v
    for k, v in layout.plan_arrays(plan).items():
        out[f"plan_arrays.{k}"] = v
    state = tuple(a[n] for n in ("elig0", "parked0", "resume0", "adm0",
                                 "adm_seq0", "adm_usage0", "adm_uses0",
                                 "death0", "u_cq0"))
    for i, v in enumerate(layout.permute_state(state)):
        out[f"state.{i}"] = v
    rng = np.random.default_rng(plan.C)
    F = a["u_cq0"].shape[1]
    ext = (rng.integers(0, 3, (4, plan.C, F)).astype(np.int32),
           rng.random((4, plan.G)) < 0.5)
    for i, v in enumerate(layout.permute_ext(*ext)):
        out[f"ext.{i}"] = v
    return out


def scatter_case(seed: int = 0, C: int = 12, M: int = 5, D: int = 3):
    """``(planes, rows, vals)`` of the resident row scatter: 13 planes
    shaped and typed like the SCATTER tier (``parallel.sharded.
    SCATTER_PLANES``: [C, M, 2], [C, M], [C, M, 4], [C, 4] and [C]
    planes, int32 and bool: at M = 5 bool rows of 5 bytes, 16-byte
    ``u_cq0`` rows), one row past the planes (C + 2: a scatter drops it)
    and D distinct dirty rows, padded to ``scatter_pad`` of their count
    by repeating the last row with its own values, and their values."""
    from .ops.packing import scatter_pad
    from .parallel.sharded import _C_FILLS, SCATTER_PLANES
    rng = np.random.default_rng(seed)
    tails = {"wl_req": (M, 2), "adm_usage0": (M, 4), "adm_uses0": (M, 4),
             "u_cq0": (4,), "strict_cq": ()}
    rows = np.concatenate([np.array([C + 2], np.int32),
                           rng.choice(C, D, replace=False).astype(np.int32)])
    D = len(rows)
    Dp = scatter_pad(D)
    rows = np.concatenate([rows, np.repeat(rows[-1:], Dp - D)])
    planes, vals = [], []
    for name in SCATTER_PLANES:
        shape = tails.get(name, (M,))
        if isinstance(_C_FILLS[name], bool):
            pl = rng.random((C,) + shape) < 0.5
            v = rng.random((D,) + shape) < 0.5
        else:
            pl = rng.integers(-5, 50, (C,) + shape).astype(np.int32)
            v = rng.integers(-5, 50, (D,) + shape).astype(np.int32)
        planes.append(pl)
        vals.append(np.concatenate([v, np.repeat(v[-1:], Dp - D, axis=0)]))
    return planes, rows, vals


def dflags_blocks(S: int, K: int, seed: int | None = None) -> np.ndarray:
    """S [K, 4] int32 dirty-flag blocks as S shards' burst launches leave
    them: lanes 0-2 set at random, lane 3 (DIRTY_RESUME) 0."""
    rng = np.random.default_rng(S * K if seed is None else seed)
    blocks = (rng.random((S, K, 4)) < 0.2).astype(np.int32)
    blocks[:, :, 3] = 0
    return blocks


# ----------------------------------------------------------------------
# The per-cycle mesh (parallel/sharded.py): gather and merge cases, the
# fair-sharing preemption cluster of the sharded conformance rows
# ----------------------------------------------------------------------

def _shard_heads(rng, W: int, S: int, n_valid: int, empty=()) -> tuple:
    """The first ``n_valid`` of W heads dealt to S shards at random (none
    to the shards in ``empty``), each shard's list ascending → S int32
    maps."""
    live = [s for s in range(S) if s not in empty]
    shard = np.full(W, -1)
    shard[:n_valid] = rng.choice(live, n_valid)
    return tuple(np.flatnonzero(shard == s).astype(np.int32)
                 for s in range(S))


def gather_case(rng: np.random.Generator, *, W: int, S: int,
                n_valid: int | None = None, empty=(),
                dtypes=("bool", "int32")) -> tuple:
    """``(planes, head_of, fills)`` of the head gather: one plane per
    dtype (S blocks [W_s] each), the S ascending maps of the first
    ``n_valid`` heads (the rest belong to no shard; shards in ``empty``
    get none), and the fills the unsharded kernels give (False, -1)."""
    head_of = _shard_heads(rng, W, S, W if n_valid is None else n_valid,
                           empty)
    planes, fills = [], []
    for dt in dtypes:
        if dt == "bool":
            planes.append(tuple(rng.random(len(h)) < 0.5 for h in head_of))
            fills.append(False)
        else:
            planes.append(tuple(rng.integers(-3, 9, len(h)).astype(np.int32)
                                for h in head_of))
            fills.append(-1)
    return tuple(planes), head_of, tuple(fills)


def merge_case(rng: np.random.Generator, *, W: int, S: int,
               n_valid: int | None = None, empty=(),
               short: bool = False) -> tuple:
    """``(winners, head_of)`` of the fair-sharing round merge: each
    shard's winners a permutation of its local ids (``short``: one live
    shard's sequence ends early, -1 after it)."""
    head_of = _shard_heads(rng, W, S, W if n_valid is None else n_valid,
                           empty)
    winners = [rng.permutation(len(h)).astype(np.int32) for h in head_of]
    if short:
        s = next(s for s, h in enumerate(head_of) if len(h) > 1)
        winners[s][len(winners[s]) // 2:] = -1
    return tuple(winners), head_of


# the warp-per-forest preempt scan's layouts: (label, preempt_cycle
# keyword arguments); every head's targets in its own forest
PREEMPT_ROUTE_CASES = [
    # the north star's cohorts of five, heads interleaved in cycle order
    ("cohorts_of_5", dict(n_cqs=60, n_cohorts=12, depth=2, F=1, W=200, R=1,
                          per=5, T=256, MT=8, n_targets=160)),
    ("nested", dict(n_cqs=24, n_cohorts=8, depth=3, F=3, W=48, R=2,
                    roots=5, T=64, MT=4, n_targets=20)),
    ("depth_17", dict(n_cqs=6, n_cohorts=16, depth=2, F=3, W=24, R=2,
                      chain=True, T=64, MT=4, n_targets=12)),
    ("F_12", dict(n_cqs=40, n_cohorts=10, depth=3, F=12, W=64, R=4, roots=4,
                  T=64, MT=4, n_targets=30)),
    ("one_forest", dict(n_cqs=40, n_cohorts=6, depth=3, F=3, W=64, R=2,
                        roots=1, T=64, MT=6, n_targets=24)),
]


def preempt_route_cases(seed: int = 0):
    """Yield (label, admit_scan_preempt's positional numpy arrays, depth,
    (forest_of_node, n_forests)) over ``PREEMPT_ROUTE_CASES`` and the
    cross-forest case under its joined tables."""
    rng = np.random.default_rng(seed)
    for label, kw in PREEMPT_ROUTE_CASES:
        c = preempt_cycle(rng, in_forest=True, **kw)
        yield (label, preempt_args(c), c["depth"],
               (c["forest_of_node"], c["n_forests"]))
    c = cross_forest_case()
    args = preempt_args(c)
    yield "cross_forest", args, c["depth"], preempt_tables(args)


def cross_forest_case() -> dict:
    """A preempt cycle whose one preempting head names a target in
    another cohort forest (CQ 0 under cohort 4, the target's CQ 2 under
    cohort 5): never seen in a Kueue cycle, refused by the
    forest-sharded scan."""
    c = preempt_cycle(np.random.default_rng(0), n_cqs=4, n_cohorts=2,
                      depth=2, F=1, W=4, R=1, T=64, MT=4, n_targets=2,
                      roots=2, in_forest=True)
    c["parent"] = np.array([4, 4, 5, 5, -1, -1], dtype=np.int32)
    c["forest_of_node"] = np.array([0, 0, 1, 1, 0, 1], dtype=np.int32)
    c["n_forests"] = 2
    c["wl_cq"] = np.array([0, 1, 2, 3], dtype=np.int32)
    c["preempt_mask"] = np.array([True, False, False, False])
    c["fit_mask"][0] = False
    c["res_mask"][:] = False
    c["tgt_mat"][:] = -1
    c["tgt_mat"][0, 0] = 1
    c["tu_cq"][:2] = (0, 2)
    return c


def fs_preemption_cluster(t, d) -> None:
    """tests/test_conformance_fair_preemption.py's cluster on a
    ``Driver(fair_sharing=True)`` of either package (``t`` its
    api.types): CQs a/b/c (nominal 3 cpu each) and "preemptible"
    (nominal 0) in cohort "all", borrowWithinCohort LowerPriority
    threshold -3, withinClusterQueue LowerPriority, reclaimWithinCohort
    Any."""
    d.apply_resource_flavor(t.ResourceFlavor(name="default"))
    policy = t.PreemptionPolicy(
        within_cluster_queue=t.WithinClusterQueue.LOWER_PRIORITY,
        reclaim_within_cohort=t.ReclaimWithinCohort.ANY,
        borrow_within_cohort=t.BorrowWithinCohort(
            policy=t.BorrowWithinCohortPolicy.LOWER_PRIORITY,
            max_priority_threshold=-3))
    for name, nominal, pre in (("a", 3000, policy), ("b", 3000, policy),
                               ("c", 3000, policy), ("preemptible", 0,
                                                     None)):
        d.apply_cluster_queue(t.ClusterQueue(
            name=name, cohort="all",
            **({"preemption": pre} if pre is not None else {}),
            resource_groups=[t.ResourceGroup(
                covered_resources=["cpu"], flavors=[t.FlavorQuotas(
                    name="default", resources={
                        "cpu": t.ResourceQuota(nominal=nominal)})])]))
        d.apply_local_queue(t.LocalQueue(name=f"lq-{name}",
                                         cluster_queue=name))


def reserve(t, w, d, name, cq_name, cpu, priority=0, at=0.5) -> None:
    """tests/test_conformance_preemption.py ``admit``: a workload of
    ``cpu`` on flavor "default" restored with its quota reserved in
    ``cq_name`` (``w`` the package's workload module)."""
    wl = t.Workload(
        name=name, namespace="default", priority=priority,
        creation_time=at, pod_sets=[t.PodSet(
            name="main", count=1, requests={"cpu": cpu})])
    adm = t.Admission(cluster_queue=cq_name, pod_set_assignments=[
        t.PodSetAssignment(name="main", flavors={"cpu": "default"},
                           resource_usage={"cpu": cpu}, count=1)])
    w.set_quota_reservation(wl, adm, at)
    w.sync_admitted_condition(wl, at)
    d.restore_workload(wl)


def submit(t, d, name, cq_name, cpu, priority=0, created=999.0) -> None:
    """tests/test_conformance_preemption.py ``incoming``."""
    d.create_workload(t.Workload(
        name=name, namespace="default", queue_name=f"lq-{cq_name}",
        priority=priority, creation_time=created,
        pod_sets=[t.PodSet(name="main", count=1, requests={"cpu": cpu})]))
