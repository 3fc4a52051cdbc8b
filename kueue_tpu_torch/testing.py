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
           depth: int):
    """parent [N] (CQs first, then cohorts), forest_of_node [N],
    n_forests, and the true depth (<= ``depth`` levels)."""
    N = n_cqs + n_cohorts
    parent = np.full(N, -1, dtype=np.int32)
    level = np.zeros(N, dtype=np.int32)
    # cohorts: each picks a parent cohort one level up, keeping the
    # cohort levels within depth - 1 so a CQ below fits in depth levels
    for j in range(n_cohorts):
        node = n_cqs + j
        if j > 0 and depth > 2 and rng.random() < 0.6:
            cands = [n_cqs + i for i in range(j) if level[n_cqs + i] < depth - 2]
            if cands:
                p = int(rng.choice(cands))
                parent[node] = p
                level[node] = level[p] + 1
    for c in range(n_cqs):
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
                reserve: bool = True) -> dict:
    """Inputs of admit_scan / admit_scan_forests (with ``forest_of_node``,
    ``n_forests`` and ``max_forest_wl``), as numpy arrays; ``depth`` is
    the static depth argument."""
    parent, forest_of, n_forests, true_depth = forest(rng, n_cqs, n_cohorts,
                                                      depth)
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
                  n_targets: int | None = None, **kw) -> dict:
    """Inputs of admit_scan_preempt: ``admit_cycle`` plus preempt heads
    whose target lists overlap."""
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
    for w in np.nonzero(pmask)[0]:
        k = int(rng.integers(1, min(MT, n_targets) + 1))
        # a small universe makes target lists overlap between heads
        tgt_mat[w, :k] = rng.choice(n_targets, size=k, replace=False)
    tu_cq = np.zeros(T, dtype=np.int32)
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
                        F: int = 2) -> dict:
    """Inputs of minimal_preemptions_batch: S forest-local searches over
    [S, NL, F] planes, padded searches (pre_cq = -1) past ``n_valid``."""
    NL = n_cqs + n_cohorts
    n_valid = S if n_valid is None else n_valid
    planes = {k: [] for k in ("usage0", "subtree", "guaranteed",
                              "borrow_cap", "has_blim", "parent")}
    depths = []
    for _ in range(S):
        parent, _, _, d = forest(rng, n_cqs, n_cohorts, depth)
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


# ----------------------------------------------------------------------
# The fused burst (ops/burst.py burst_cycles)
# ----------------------------------------------------------------------

def burst_synthetic(rng: np.random.Generator, *, C: int = 12, M: int = 16,
                    R: int = 1, S: int = 1, K: int = 8, per: int = 4,
                    runtime: int = 3, ties: bool = False,
                    deep: bool = False):
    """A seeded synthetic burst window: ``(args, kw)`` in
    ``ops.burst.ARG_NAMES`` order.  CQs sit in cohorts of ``per`` (one
    cohort node each; ``deep`` adds a root above every two cohorts, a
    depth the preemption envelope excludes), with pending and admitted
    rows, usage consistent with the admitted rows, low nominal quota so
    heads need preemption, finishes and external release / unpark events
    inside the window, a few heads outside the vectorized coverage, and
    StrictFIFO CQs.  ``ties`` gives candidates equal ordering keys and
    heads equal cycle ranks, so only the stable sorts' index order
    separates them."""
    from .ops.burst import build_candidate_tables, build_members
    from .ops.cycle import available_all_np
    G0 = -(-C // per)
    n_top = -(-G0 // 2) if deep else 0
    N = C + G0 + n_top
    F = S * R
    parent = np.full(N, -1, dtype=np.int32)
    parent[:C] = C + np.arange(C) // per
    if deep:
        parent[C:C + G0] = C + G0 + np.arange(G0) // 2
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
             zero_lend: float = 0.2, ties: bool = False) -> dict:
    """Inputs of fs_admit_scan (``ops.fs_scan.FS_ARGS`` plus ``depth`` and
    ``n_levels``) as numpy arrays: a cohort forest of up to ``depth``
    levels, usage that borrows above subtree quota, lendable capacity
    that is zero at roots and at a ``zero_lend`` share of the other nodes
    (the floor-division case), one head per CQ in the first ``n_valid``
    rows and padding after, NoFit heads, and with ``ties`` equal
    priorities and timestamp ranks."""
    parent, forest_of, _, true_depth = forest(rng, n_cqs, n_cohorts, depth)
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
        n_levels=int(level.max()) + 1)


def fs_args(case: dict) -> tuple:
    """fs_admit_scan's positional arrays (``ops.fs_scan.FS_ARGS``)."""
    from .ops.fs_scan import FS_ARGS
    return tuple(case[k] for k in FS_ARGS)


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
        forest_of_node=np.zeros(3, np.int32), depth=2, n_levels=2)


# (n_cqs, n_cohorts, depth, F, R, W, n_valid, ties, weights, zero_lend)
FS_SHAPES = [
    (6, 2, 2, 1, 1, 8, 6, False, FS_WEIGHTS, 0.2),         # flat
    (8, 3, 2, 2, 2, 16, 7, True, FS_WEIGHTS, 0.2),         # ties, padding
    (10, 4, 3, 3, 2, 16, 10, False, FS_WEIGHTS, 0.2),      # nested
    (12, 4, 3, 1, 1, 16, 12, True, (0, 1000), 0.0),        # MAX_DRS
    (9, 3, 2, 1, 1, 16, 9, False, (3000, 4000), 1.0),      # floor division
    (10, 4, 3, 2, 2, 16, 10, True, (3000, 4000), 0.5),
    (60, 20, 3, 2, 1, 64, 50, False, FS_WEIGHTS, 0.2),     # N > 64
    (60, 20, 2, 2, 2, 64, 60, True, FS_WEIGHTS, 0.3),
    (1000, 200, 2, 1, 1, 1024, 1000, False, FS_WEIGHTS, 0.2),  # north star
]
# (n_cqs, n_cohorts, depth, F, R, with wl_req)
DRS_SHAPES = [
    (6, 3, 2, 1, 1, False),
    (8, 4, 3, 3, 2, True),
    (60, 20, 3, 4, 2, False),
    (60, 20, 3, 2, 2, True),
    (1000, 200, 2, 1, 1, False),
]


def drs_case(rng: np.random.Generator, *, n_cqs: int, n_cohorts: int,
             depth: int, F: int, R: int, wl_req: bool) -> tuple:
    """(positional arrays, keywords) of drs_components."""
    parent, _, _, true_depth = forest(rng, n_cqs, n_cohorts, depth)
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
    for n_cqs, n_coh, depth, F, R, W, n_valid, ties, w, zl in FS_SHAPES:
        c = fs_cycle(rng, n_cqs=n_cqs, n_cohorts=n_coh, depth=depth, F=F,
                     R=R, W=W, n_valid=n_valid, ties=ties, weights=w,
                     zero_lend=zl)
        yield "fs_admit_scan", fs_args(c), dict(depth=c["depth"],
                                                n_levels=c["n_levels"])
    c = fs_floor_case()
    yield "fs_admit_scan", fs_args(c), dict(depth=c["depth"],
                                            n_levels=c["n_levels"])
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


# (n_levels, n_roots, fanout, ties) by part name
TAS_SHAPES = {
    "three_levels": (3, 3, 4, False),
    "ties": (3, 2, 3, True),      # id order decides (reversed: LeastFree)
    "two_levels": (2, 4, 5, False),
    "one_level": (1, 6, 1, False),
    "wide": (3, 4, 6, False),
    "tas4k": (3, 8, 32, False),   # the tas-4k cluster's shape, ragged
}
TAS_PARTS = ("three_levels", "ties", "two_levels", "one_level", "wide",
             "wrap", "flat")


def tas_cases(seed: int = 0, parts=TAS_PARTS, *, flat: int = 80):
    """The TAS sweep a CUDA kernel is held to against its plain version,
    and the plain version against the JAX programs: ``(name, positional
    arrays, keywords)`` over the named ``parts`` — seeded snapshots of
    ``TAS_SHAPES`` (1-3 levels, ragged, zero capacities, a resource no
    leaf has) under every request of ``TAS_REQUESTS``, the wrapping case
    (``wrap``) and a flat level of ``flat`` roots (``flat``).  Each part
    draws from its own generator, so any subset gives the same cases."""
    from .ops.tas_kernel import pack_tas
    for j, part in enumerate(TAS_PARTS + ("tas4k",)):
        if part not in parts:
            continue
        rng = np.random.default_rng([seed, j])
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
        for request in TAS_REQUESTS:
            leaf_free, per_pod = tas_query_inputs(packed, request)
            counts = _tas_counts(leaf_free, per_pod, packed.parents, sizes)
            yield from tas_sweep(leaf_free, per_pod, packed.parents, sizes,
                                 counts)
