"""The batched admission cycle: host nominate + sequential admit scans.

Phase 1 (vectorized nominate, host numpy): ``classify_np`` classifies
every head against every flavor slot at once — Fit / Preempt-capable /
NoFit — mirroring findFlavorForPodSetResource (flavorassigner.go:499)
under the CQ's FlavorFungibility policy.  It is the JAX package's numpy
code, unchanged.

Phase 2 (the admit scans): the sequential admit loop over the cycle
order, with assignments FIXED at nominate time — each entry only
re-checks that its (flavor-resource, amount) pairs still fit under the
usage changed by earlier entries (scheduler.go:245/372), preempt entries
without candidates reserve capacity (scheduler.go:383-408), and preempt
entries with targets preempt in-scan (scheduler.go:176-284).  Each scan
has a plain PyTorch version here and a CUDA kernel in ``kernels/``:

- ``admit_scan``          kernels/admit_scan.cu
- ``admit_scan_forests``  kernels/admit_scan_forests.cu
- ``admit_scan_preempt``  kernels/admit_scan_preempt.cu

The public function takes the kernel for CUDA tensors and the plain
version for CPU tensors, and raises for any other device.

The one-call solvers ``solve_cycle`` / ``solve_cycle_forests`` (the
probe and entry-point surface) run phase 1 on the device too: the CQ
rows' availability, the per-head classify with the FlavorFungibility
walk and the stable cycle order, each a plain PyTorch version here and
a kernel in ``kernels/solve_cycle.cu`` (``cq_avail``, ``classify_heads``,
``cycle_order``), then one of the admit scans above.
"""

from __future__ import annotations

import numpy as np
import torch

from .quota_kernel import (add_usage_chain_, available_all, available_at,
                           remove_usage_chain_)


# ----------------------------------------------------------------------
# Host-side (numpy) phase 1
# ----------------------------------------------------------------------

def available_all_np(usage, subtree, guaranteed, borrow_cap, has_blim,
                     parent, depth: int) -> np.ndarray:
    """numpy twin of quota_kernel.available_all (resource_node.go:89)."""
    is_root = (parent < 0)[:, None]
    parent_safe = np.maximum(parent, 0)
    root_avail = subtree.astype(np.int64) - usage
    local = np.maximum(0, guaranteed.astype(np.int64) - usage)
    used_in_parent = np.maximum(0, usage.astype(np.int64) - guaranteed)
    blim_cap = borrow_cap.astype(np.int64) - used_in_parent
    avail = root_avail.copy()
    for _ in range(depth):
        parent_avail = avail[parent_safe]
        parent_avail = np.where(has_blim, np.minimum(blim_cap, parent_avail),
                                parent_avail)
        avail = np.where(is_root, root_avail, local + parent_avail)
    return avail


def classify_np(packed, avail0=None, potential0=None, start_slot=None):
    """Vectorized nominate on the host: per-head slot classification.

    The per-head flavor walk (flavorassigner.go:499) is evaluated dense
    over all slots and then resolved under the CQ's FlavorFungibility
    policy: a slot STOPS the walk when it fits without borrowing, fits
    borrowing under whenCanBorrow=Borrow, or is preempt-capable under
    whenCanPreempt=Preempt (shouldTryNextFlavor, :620); otherwise the
    walk keeps the best-mode slot seen (Fit > Preempt > NoFit, first
    occurrence wins), with a stop slot overriding any earlier best.
    ``start_slot`` [W] carries the fungibility resume index
    (last_tried_flavor_idx + 1); slots below it are never attempted.

    Returns a dict of [W]-shaped arrays:
      fit_slot0     the walk's chosen Fit slot or -1
      borrows0      the fit assignment borrows
      preempt0      no fit chosen, the walk chose a preempt-capable slot
      preempt_slot0 that slot
      preempt_borrows0  that preempt assignment borrows
      preempt_res_fit   [W, R] per-resource Fit flag on the preempt slot
                    (False ⇒ the resource is the one needing preemption)
      preempt_stopped0  the walk STOPPED at the preempt slot (the choice
                    is policy-forced, independent of the reclaim oracle)
    """
    st = packed.structure
    usage0 = packed.usage0
    if avail0 is None:
        avail0 = available_all_np(
            usage0, st.subtree_quota, st.guaranteed, st.borrow_cap,
            st.has_borrow_limit, st.parent, st.depth)
    if potential0 is None:
        potential0 = available_all_np(
            np.zeros_like(usage0), st.subtree_quota, st.guaranteed,
            st.borrow_cap, st.has_borrow_limit, st.parent, st.depth)

    wl_cq = packed.wl_cq
    req = packed.wl_requests.astype(np.int64)[:, None, :]   # [W,1,R]
    cqs = np.maximum(wl_cq, 0)
    frs = st.slot_fr[cqs]                                   # [W,S,R]
    frs_safe = np.maximum(frs, 0)
    covered = frs >= 0
    needed = req > 0
    missing = np.any(needed & ~covered, axis=2)             # [W,S]
    av = avail0[cqs[:, None, None], frs_safe]               # [W,S,R]
    pot = potential0[cqs[:, None, None], frs_safe]
    nom = st.nominal_cq[cqs[:, None, None], frs_safe]
    use = usage0[cqs[:, None, None], frs_safe]
    sq = st.subtree_quota[cqs[:, None, None], frs_safe]

    relevant = covered & needed
    fit_r = req <= av
    nofit_r = req > pot
    preempt_capable_r = (req <= nom) | st.cq_can_preempt_borrow[cqs][:, None, None]
    res_nofit = relevant & (nofit_r | (~fit_r & ~preempt_capable_r))

    slot_ok = st.slot_valid[cqs]
    fit_s = (np.all(np.where(relevant, fit_r, True), axis=2)
             & ~missing & slot_ok)                          # [W,S]
    nofit_s = np.any(res_nofit, axis=2) | missing | ~slot_ok
    preempt_s = ~fit_s & ~nofit_s
    has_parent = st.parent[cqs] >= 0
    borrow_r = np.where(relevant, use + req > sq, False)
    borrows_s = np.any(borrow_r, axis=2) & has_parent[:, None]

    valid = wl_cq >= 0
    W = len(cqs)
    S = fit_s.shape[1]
    w = np.arange(W)
    wcb = st.cq_wcb_borrow[cqs]
    wcp = st.cq_wcp_preempt[cqs]
    if start_slot is None:
        start = np.zeros(W, dtype=np.int32)
    else:
        start = np.asarray(start_slot, dtype=np.int32)
    active_s = np.arange(S)[None, :] >= start[:, None]      # [W, S]
    stop_s = (active_s & (fit_s | (preempt_s & wcp[:, None]))
              & (~borrows_s | wcb[:, None]))
    has_stop = np.any(stop_s, axis=1)
    stop_idx = np.argmax(stop_s, axis=1)
    act_mode = np.where(active_s,
                        np.where(fit_s, 2, np.where(preempt_s, 1, 0)), 0)
    best_mode = act_mode.max(axis=1)
    best_idx = np.argmax((act_mode == best_mode[:, None]) & active_s,
                         axis=1)
    chosen = np.where(has_stop, stop_idx, best_idx)
    chosen_mode = act_mode[w, chosen]

    has_fit = (chosen_mode == 2) & valid
    fit_slot0 = np.where(has_fit, chosen, -1).astype(np.int32)
    borrows0 = borrows_s[w, chosen] & has_fit

    has_preempt = (chosen_mode == 1) & valid
    preempt_slot0 = np.where(has_preempt, chosen, -1).astype(np.int32)
    preempt_borrows0 = borrows_s[w, chosen] & has_preempt
    # per-resource fit on the preempt slot (for frs_need_preemption)
    preempt_res_fit = fit_r[w, chosen] | ~relevant[w, chosen]
    # how many attempted slots are preempt-capable: with exactly one, the
    # host walk picks it regardless of the reclaim oracle (the oracle only
    # reorders among preempt-capable flavors — flavorassigner.go:692
    # RECLAIM vs PREEMPT), so the device may fix the slot without running
    # the oracle; a policy STOP at the slot forces it the same way
    preempt_slot_count = (preempt_s & active_s).sum(axis=1).astype(np.int32)
    preempt_stopped0 = has_preempt & has_stop

    return {
        "fit_slot0": fit_slot0,
        "borrows0": borrows0,
        "preempt0": has_preempt,
        "preempt_slot0": preempt_slot0,
        "preempt_borrows0": preempt_borrows0,
        "preempt_res_fit": preempt_res_fit,
        "preempt_slot_count": preempt_slot_count,
        "preempt_stopped0": preempt_stopped0,
        "avail0": avail0,
        "potential0": potential0,
    }


def cycle_order_np(borrows, priority, timestamp) -> np.ndarray:
    """entryOrdering.Less (scheduler.go:567): borrows asc, priority desc,
    timestamp asc, stable."""
    W = len(priority)
    return np.lexsort((np.arange(W), timestamp, -priority,
                       borrows.astype(np.int32))).astype(np.int32)


def decision_pairs_from_slots(slot_fr, wl_cq, wl_requests, fit_slot0):
    """Single-slot classifications → decision pairs (numpy or tensors).

    dec_fr/dec_amt [W, R]: the chosen slot's flavor-resource per requested
    resource (-1 where not requested or not fit); fit_mask [W]."""
    if isinstance(wl_cq, torch.Tensor):
        frs = slot_fr[wl_cq.clamp(min=0).long(),
                      fit_slot0.clamp(min=0).long()]           # [W, R]
        fit_mask = (fit_slot0 >= 0) & (wl_cq >= 0)
        relevant = (frs >= 0) & (wl_requests > 0) & fit_mask[:, None]
        return (torch.where(relevant, frs, -1).to(torch.int32),
                torch.where(relevant, wl_requests, 0).to(torch.int32),
                fit_mask)
    cqs = np.maximum(wl_cq, 0)
    slots = np.maximum(fit_slot0, 0)
    frs = slot_fr[cqs, slots]                               # [W, R]
    fit_mask = (fit_slot0 >= 0) & (wl_cq >= 0)
    relevant = (frs >= 0) & (wl_requests > 0) & fit_mask[:, None]
    dec_fr = np.where(relevant, frs, -1).astype(np.int32)
    dec_amt = np.where(relevant, wl_requests, 0).astype(np.int32)
    return dec_fr, dec_amt, fit_mask


# ----------------------------------------------------------------------
# Admit scans: plain PyTorch versions
# ----------------------------------------------------------------------

def _pairs_fit(fr: torch.Tensor, amt: torch.Tensor,
               avail_row: torch.Tensor) -> bool:
    relevant = fr >= 0
    return bool(torch.where(relevant, amt <= avail_row[fr.clamp(min=0).long()],
                            True).all())


def _pairs_add_(delta: torch.Tensor, fr: torch.Tensor,
                amt: torch.Tensor) -> None:
    delta.index_add_(0, fr.clamp(min=0).long(),
                     torch.where(fr >= 0, amt, 0))


def _reserve_add_(delta, usage, cq, wi, nominal_cq, npb_cq, res_fr, res_amt,
                  res_borrows) -> None:
    """resourcesToReserve (scheduler.go:383-408) for head wi of CQ cq."""
    rfrs = res_fr[wi]
    ramt = res_amt[wi]
    rsafe = rfrs.clamp(min=0).long()
    cur = usage[cq][rsafe]
    if bool(res_borrows[wi]):
        rdelta = torch.minimum(ramt, npb_cq[cq][rsafe] - cur)
    else:
        rdelta = torch.minimum(ramt, nominal_cq[cq][rsafe] - cur).clamp(min=0)
    delta.index_add_(0, rsafe, torch.where(rfrs >= 0, rdelta, 0))


def _admit_entry_(usage, wi, valid, *, subtree, guaranteed, borrow_cap,
                  has_blim, parent, nominal_cq, npb_cq, wl_cq_l, dec_fr,
                  dec_amt, fit_mask, res_fr, res_amt, res_mask, res_borrows,
                  depth) -> bool:
    """One entry of the fixed-assignment admit loop (cycle.py
    _entry_decision + _admit_step of the JAX package), updating ``usage``
    in place.  Returns the admit decision."""
    cq = max(wl_cq_l[wi], 0)
    avail_row = available_at(usage, subtree, guaranteed, borrow_cap,
                             has_blim, parent, cq, depth)
    admit = (bool(fit_mask[wi]) and valid
             and _pairs_fit(dec_fr[wi], dec_amt[wi], avail_row))
    is_res = bool(res_mask[wi]) and valid
    if admit or is_res:
        delta = torch.zeros(usage.shape[1], dtype=usage.dtype,
                            device=usage.device)
        if admit:
            _pairs_add_(delta, dec_fr[wi], dec_amt[wi])
        if is_res:
            _reserve_add_(delta, usage, cq, wi, nominal_cq, npb_cq, res_fr,
                          res_amt, res_borrows)
        add_usage_chain_(usage, wl_cq_l[wi], delta, guaranteed, parent,
                         depth)
    return admit


def admit_scan_plain(usage0, subtree, guaranteed, borrow_cap, has_blim,
                     parent, nominal_cq, npb_cq, wl_cq, dec_fr, dec_amt,
                     fit_mask, res_fr, res_amt, res_mask, res_borrows,
                     order, *, depth: int, forest_of_node=None,
                     n_forests=None) -> torch.Tensor:
    """The sequential admit loop over ``order`` → admitted [W] bool (head
    order).  ``forest_of_node`` / ``n_forests`` only place the CUDA
    kernel's blocks; the loop ignores them."""
    usage = usage0.clone()
    wl_cq_l = wl_cq.tolist()
    admitted = torch.zeros(wl_cq.shape[0], dtype=torch.bool,
                           device=usage0.device)
    for wi in order.tolist():
        admitted[wi] = _admit_entry_(
            usage, wi, wl_cq_l[wi] >= 0, subtree=subtree,
            guaranteed=guaranteed, borrow_cap=borrow_cap, has_blim=has_blim,
            parent=parent, nominal_cq=nominal_cq, npb_cq=npb_cq,
            wl_cq_l=wl_cq_l, dec_fr=dec_fr, dec_amt=dec_amt,
            fit_mask=fit_mask, res_fr=res_fr, res_amt=res_amt,
            res_mask=res_mask, res_borrows=res_borrows, depth=depth)
    return admitted


def forest_schedule(order, wl_cq, forest_of_node, n_forests: int,
                    max_forest_wl: int) -> list[list[int]]:
    """Each forest's heads in cycle order, at most ``max_forest_wl`` of
    them (the JAX package's _forest_schedule, without the padding
    bucket: heads with wl_cq < 0 are never scheduled)."""
    lists: list[list[int]] = [[] for _ in range(n_forests)]
    wl_cq_l = wl_cq.tolist()
    forest_l = forest_of_node.tolist()
    for wi in order.tolist():
        cq = wl_cq_l[wi]
        if cq < 0:
            continue
        f = forest_l[cq]
        if 0 <= f < n_forests and len(lists[f]) < max_forest_wl:
            lists[f].append(wi)
    return lists


def admit_scan_forests_plain(usage0, subtree, guaranteed, borrow_cap,
                             has_blim, parent, nominal_cq, npb_cq, wl_cq,
                             dec_fr, dec_amt, fit_mask, res_fr, res_amt,
                             res_mask, res_borrows, order, forest_of_node,
                             *, depth: int, n_forests: int,
                             max_forest_wl: int) -> torch.Tensor:
    """``admit_scan`` forest by forest: quota never flows between cohort
    forests, so each forest's heads are decided alone, in cycle order."""
    usage = usage0.clone()
    wl_cq_l = wl_cq.tolist()
    admitted = torch.zeros(wl_cq.shape[0], dtype=torch.bool,
                           device=usage0.device)
    for heads in forest_schedule(order, wl_cq, forest_of_node, n_forests,
                                 max_forest_wl):
        for wi in heads:
            admitted[wi] = _admit_entry_(
                usage, wi, True, subtree=subtree, guaranteed=guaranteed,
                borrow_cap=borrow_cap, has_blim=has_blim, parent=parent,
                nominal_cq=nominal_cq, npb_cq=npb_cq, wl_cq_l=wl_cq_l,
                dec_fr=dec_fr, dec_amt=dec_amt, fit_mask=fit_mask,
                res_fr=res_fr, res_amt=res_amt, res_mask=res_mask,
                res_borrows=res_borrows, depth=depth)
    return admitted


def admit_scan_preempt_plain(usage0, subtree, guaranteed, borrow_cap,
                             has_blim, parent, nominal_cq, npb_cq, wl_cq,
                             dec_fr, dec_amt, fit_mask, res_fr, res_amt,
                             res_mask, res_borrows, preempt_mask, pre_fr,
                             pre_amt, tgt_mat, tu_cq, tu_delta, order,
                             *, depth: int, forest_of_node=None,
                             n_forests=None, error=None):
    """``admit_scan`` with preempting entries.  ``forest_of_node``,
    ``n_forests`` and ``error`` only serve the CUDA kernel; the loop
    ignores them.

    Carries (usage, check, used): ``usage`` follows the live snapshot
    (admits + reserves + preemptor additions, targets NOT removed —
    scheduler.go:272), ``check`` additionally has every preempted target
    removed (what fits checks against, scheduler.go:372-381), ``used`` is
    the PreemptedWorkloads set.  Returns (admitted, preempting,
    overlap_skip), each [W] bool in head order."""
    W = wl_cq.shape[0]
    dev = usage0.device
    usage = usage0.clone()
    check = usage0.clone()
    used = [False] * tu_cq.shape[0]
    wl_cq_l = wl_cq.tolist()
    tgt_l = tgt_mat.tolist()
    tu_cq_l = tu_cq.tolist()
    admitted = torch.zeros(W, dtype=torch.bool, device=dev)
    preempting_o = torch.zeros(W, dtype=torch.bool, device=dev)
    skip_o = torch.zeros(W, dtype=torch.bool, device=dev)
    kw = dict(subtree=subtree, guaranteed=guaranteed, borrow_cap=borrow_cap,
              has_blim=has_blim, parent=parent)
    for wi in order.tolist():
        valid = wl_cq_l[wi] >= 0
        cq = max(wl_cq_l[wi], 0)
        avail_check = available_at(check, node=cq, depth=depth, **kw)
        admit = (bool(fit_mask[wi]) and valid
                 and _pairs_fit(dec_fr[wi], dec_amt[wi], avail_check))

        is_pre = bool(preempt_mask[wi]) and valid
        tgts = [t for t in tgt_l[wi] if t >= 0]
        overlap = any(used[t] for t in tgts)
        preempting = False
        trial = None
        if is_pre and not overlap:
            trial = check.clone()
            for t in tgts:
                remove_usage_chain_(trial, tu_cq_l[t], tu_delta[t],
                                    guaranteed, parent, depth)
            avail_try = available_at(trial, node=cq, depth=depth, **kw)
            preempting = _pairs_fit(pre_fr[wi], pre_amt[wi], avail_try)
            if preempting:
                for t in tgts:
                    used[t] = True

        is_res = bool(res_mask[wi]) and valid
        if admit or preempting or is_res:
            delta = torch.zeros(usage.shape[1], dtype=usage.dtype,
                                device=dev)
            if admit:
                _pairs_add_(delta, dec_fr[wi], dec_amt[wi])
            if preempting:
                _pairs_add_(delta, pre_fr[wi], pre_amt[wi])
            if is_res:
                _reserve_add_(delta, usage, cq, wi, nominal_cq, npb_cq,
                              res_fr, res_amt, res_borrows)
            add_usage_chain_(usage, wl_cq_l[wi], delta, guaranteed, parent,
                             depth)
            if preempting:
                check = trial
            add_usage_chain_(check, wl_cq_l[wi], delta, guaranteed, parent,
                             depth)
        admitted[wi] = admit
        preempting_o[wi] = preempting
        skip_o[wi] = is_pre and overlap
    return admitted, preempting_o, skip_o


# ----------------------------------------------------------------------
# Admit scans: kernel for CUDA tensors, plain version for CPU tensors
# ----------------------------------------------------------------------

def _route(t: torch.Tensor) -> bool:
    """True → CUDA kernel; False → plain version; else raise."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no admit-scan kernel for device {t.device}")


def admit_scan(*args, depth: int, forest_of_node=None,
               n_forests=None) -> torch.Tensor:
    """admitted [W] bool; args as ``admit_scan_plain``."""
    if _route(args[0]):
        from .. import kernels
        return kernels.admit_scan(*args, depth=depth,
                                  forest_of_node=forest_of_node,
                                  n_forests=n_forests)
    return admit_scan_plain(*args, depth=depth)


def admit_scan_forests(*args, depth: int, n_forests: int,
                       max_forest_wl: int) -> torch.Tensor:
    """admitted [W] bool; args as ``admit_scan_forests_plain``."""
    if _route(args[0]):
        from .. import kernels
        return kernels.admit_scan_forests(*args, depth=depth,
                                          n_forests=n_forests,
                                          max_forest_wl=max_forest_wl)
    return admit_scan_forests_plain(*args, depth=depth, n_forests=n_forests,
                                    max_forest_wl=max_forest_wl)


def admit_scan_preempt(*args, depth: int, forest_of_node=None,
                       n_forests=None, error=None):
    """(admitted, preempting, overlap_skip); args as
    ``admit_scan_preempt_plain``; the keywords as the CUDA launcher's."""
    if _route(args[0]):
        from .. import kernels
        return kernels.admit_scan_preempt(*args, depth=depth,
                                          forest_of_node=forest_of_node,
                                          n_forests=n_forests, error=error)
    return admit_scan_preempt_plain(*args, depth=depth)


def join_target_forests(forest_of_node, n_forests: int, wl_cq,
                        preempt_mask, tgt_mat, tu_cq):
    """The cohort-forest labels for ``admit_scan_preempt`` (numpy):
    ``forest_of_node`` with the forests that a preempting head (valid,
    ``preempt_mask``) and its targets connect merged, each group under
    its least label → (labels [N] int32, joined).  ``joined`` is False,
    and the labels are ``forest_of_node`` itself, when every target lies
    in its head's forest, as in every Kueue cycle."""
    fon = np.asarray(forest_of_node)
    wl = np.asarray(wl_cq)
    pre = np.asarray(preempt_mask) & (wl >= 0)
    tg = np.asarray(tgt_mat)[pre]
    head_f = np.broadcast_to(fon[wl[pre]][:, None], tg.shape)
    tgt_f = fon[np.asarray(tu_cq)[np.maximum(tg, 0)]]
    cross = (tg >= 0) & (tgt_f != head_f)
    if not cross.any():
        return fon, False
    rep = list(range(int(n_forests)))

    def find(x: int) -> int:
        while rep[x] != x:
            rep[x] = rep[rep[x]]
            x = rep[x]
        return x
    for x, y in zip(head_f[cross].tolist(), tgt_f[cross].tolist()):
        rx, ry = find(x), find(y)
        rep[max(rx, ry)] = min(rx, ry)
    roots = np.array([find(x) for x in range(len(rep))], dtype=np.int32)
    return roots[fon], True


# ----------------------------------------------------------------------
# add_usage_chain_batched (the JAX package's cycle.py:553)
# ----------------------------------------------------------------------

def add_usage_chain_batched(usage, nodes, deltas, guaranteed, parent,
                            depth: int) -> torch.Tensor:
    """addUsage() up G disjoint ancestor chains at once: returns the new
    usage [N, F].  nodes [G] int32 (-1 = no-op), deltas [G, F] int32.
    The plain twin of the JAX function, whose only caller is the forest
    scan: ``kernels/admit_scan_forests.cu`` does the same charge per
    forest with ``flat_forest.cuh``'s ``AddStep`` walk."""
    usage = usage.clone()
    cur = nodes.to(torch.int64)
    carry = deltas
    for _ in range(depth):
        valid = cur >= 0
        safe = cur.clamp(min=0)
        local_avail = (guaranteed[safe] - usage[safe]).clamp(min=0)
        usage.index_add_(0, safe, torch.where(valid[:, None], carry, 0))
        next_carry = (carry - local_avail).clamp(min=0)
        cur = torch.where(valid, parent[safe].to(torch.int64), -1)
        carry = torch.where(valid[:, None], next_carry, carry)
    return usage


# ----------------------------------------------------------------------
# The one-call solvers: phase 1 on the device, then an admit scan
# ----------------------------------------------------------------------

def cq_avail_plain(usage0, subtree, guaranteed, borrow_cap, has_blim,
                   parent, *, n_cqs: int, depth: int):
    """available() of the CQ rows for ``usage0`` and for zero usage →
    (avail0 [C, F], potential0 [C, F]) int32 — the JAX solve_cycle's two
    ``available_all`` calls (cycle.py:458-461), of which the classify
    reads the first ``n_cqs`` rows."""
    avail = available_all(usage0, subtree, guaranteed, borrow_cap, has_blim,
                          parent, depth)
    potential = available_all(torch.zeros_like(usage0), subtree,
                              guaranteed, borrow_cap, has_blim, parent,
                              depth)
    return avail[:n_cqs].contiguous(), potential[:n_cqs].contiguous()


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """jnp.argmax of a bool row: the first True index, 0 when none."""
    S = mask.shape[1]
    idx = torch.arange(S, device=mask.device).expand_as(mask)
    first = torch.where(mask, idx, S).min(dim=1).values
    return torch.where(first < S, first, 0)


def classify_heads_plain(wl_cq, wl_requests, start_slot, slot_fr,
                         slot_valid, nominal_cq, usage0, subtree, parent,
                         cq_can_preempt_borrow, cq_wcb_borrow,
                         cq_wcp_preempt, avail0, potential0, *,
                         pairs: bool):
    """The JAX solve_cycle's vmapped classify (cycle.py:463-514) as tensor
    ops over [W, S, R], int32 wrapping as XLA wraps: each head against its
    CQ's slots (fit / preempt / no-fit), the FlavorFungibility walk (the
    first stop slot, else the first slot of the best mode) → (fit_slot0
    [W] int32, borrows0 [W] bool, preempt0 [W] bool), plus the decision
    pairs (dec_fr, dec_amt, fit_mask) with ``pairs``."""
    S = slot_fr.shape[1]
    cq = wl_cq.clamp(min=0).long()
    req = wl_requests[:, None, :]                              # [W, 1, R]
    frs = slot_fr[cq]                                          # [W, S, R]
    frs_safe = frs.clamp(min=0).long()
    covered = frs >= 0
    needed = req > 0
    missing = (needed & ~covered).any(dim=2)                   # [W, S]
    cq3 = cq[:, None, None]
    av = avail0[cq3, frs_safe]
    pot = potential0[cq3, frs_safe]
    nom = nominal_cq[cq3, frs_safe]
    use = usage0[cq3, frs_safe]
    sq = subtree[cq3, frs_safe]
    relevant = covered & needed
    fit_r = req <= av
    nofit_r = req > pot
    capable_r = (req <= nom) | cq_can_preempt_borrow[cq][:, None, None]
    res_nofit = relevant & (nofit_r | (~fit_r & ~capable_r))
    slot_ok = slot_valid[cq]
    fit = torch.where(relevant, fit_r, True).all(dim=2) & ~missing & slot_ok
    nofit = res_nofit.any(dim=2) | missing | ~slot_ok
    preempt = ~fit & ~nofit
    has_parent = parent[cq] >= 0
    borrow_r = relevant & ((use + req) > sq)                   # int32 wraps
    borrows_s = borrow_r.any(dim=2) & has_parent[:, None]

    wcb = cq_wcb_borrow[cq][:, None]
    wcp = cq_wcp_preempt[cq][:, None]
    active = (torch.arange(S, device=wl_cq.device)[None, :]
              >= start_slot[:, None])
    stop = active & (fit | (preempt & wcp)) & (~borrows_s | wcb)
    has_stop = stop.any(dim=1)
    act_mode = torch.where(active, torch.where(
        fit, 2, torch.where(preempt, 1, 0)), 0)
    best_idx = _first_true(act_mode == act_mode.max(dim=1,
                                                    keepdim=True).values)
    chosen = torch.where(has_stop, _first_true(stop), best_idx)
    chosen_mode = act_mode.gather(1, chosen[:, None])[:, 0]
    has_fit = chosen_mode == 2
    valid = wl_cq >= 0
    fit_slot0 = torch.where(has_fit & valid, chosen, -1).to(torch.int32)
    borrows0 = borrows_s.gather(1, chosen[:, None])[:, 0] & has_fit & valid
    preempt0 = (chosen_mode == 1) & valid
    if not pairs:
        return fit_slot0, borrows0, preempt0
    return (fit_slot0, borrows0, preempt0,
            *decision_pairs_from_slots(slot_fr, wl_cq, wl_requests,
                                       fit_slot0))


def float32_sort_key(x: torch.Tensor) -> torch.Tensor:
    """float32 → int32 keys in XLA's sort order: -0 sorts as +0, every NaN
    as one NaN after +inf (lax.sort's canonicalized total order)."""
    x = torch.where(x == 0, torch.zeros_like(x), x)
    x = torch.where(torch.isnan(x), torch.full_like(x, float("nan")), x)
    bits = x.view(torch.int32)
    return torch.where(bits < 0, bits ^ 0x7fffffff, bits)


def cycle_order_plain(borrows0, priority, timestamp) -> torch.Tensor:
    """The JAX solve_cycle's ``jnp.lexsort((arange, timestamp, -priority,
    borrows0))`` (cycle.py:521) → order [W] int32: successive stable
    argsorts from the minor key up.  ``timestamp`` is float32 (the jit
    boundary's cast); -priority wraps at INT_MIN as int32 does."""
    neg_prio = -priority.to(torch.int64)
    neg_prio = torch.where(neg_prio == 2**31, -2**31, neg_prio)
    order = torch.arange(borrows0.shape[0], device=borrows0.device)
    for key in (float32_sort_key(timestamp), neg_prio,
                borrows0.to(torch.int32)):
        order = order[torch.argsort(key[order], stable=True)]
    return order.to(torch.int32)


def cq_avail(*args, n_cqs: int, depth: int):
    """(avail0, potential0); args as ``cq_avail_plain``."""
    if _route(args[0]):
        from .. import kernels
        return kernels.kq_cq_avail(*args, n_cqs=n_cqs, depth=depth)
    return cq_avail_plain(*args, n_cqs=n_cqs, depth=depth)


def classify_heads(*args, pairs: bool):
    """The per-head classify; args as ``classify_heads_plain``."""
    if _route(args[0]):
        from .. import kernels
        return kernels.kq_classify_heads(*args, pairs=pairs)
    return classify_heads_plain(*args, pairs=pairs)


def cycle_order(borrows0, priority, timestamp) -> torch.Tensor:
    """The stable cycle order; args as ``cycle_order_plain``."""
    if _route(borrows0):
        from .. import kernels
        return kernels.kq_cycle_order(borrows0, priority, timestamp)
    return cycle_order_plain(borrows0, priority, timestamp)


def _phase1_fns(plain: bool):
    """(cq_avail, classify_heads, cycle_order, admit_scan,
    admit_scan_forests): the plain versions, or the routed functions,
    looked up at call time."""
    if plain:
        return (cq_avail_plain, classify_heads_plain, cycle_order_plain,
                admit_scan_plain, admit_scan_forests_plain)
    return cq_avail, classify_heads, cycle_order, admit_scan, \
        admit_scan_forests


def _phase1(args, cq_wcb_borrow, cq_wcp_preempt, start_slot, depth, pairs,
            plain):
    """Phase 1 of both solvers → (fit_slot0, borrows0, preempt0[, dec_fr,
    dec_amt, fit_mask]) and the float32 timestamp."""
    (usage0, subtree, guaranteed, borrow_cap, has_blim, parent, nominal_cq,
     slot_fr, slot_valid, cq_can_preempt_borrow, wl_cq, wl_requests,
     _, wl_timestamp) = args
    dev = usage0.device
    C = slot_fr.shape[0]
    W = wl_cq.shape[0]
    if cq_wcb_borrow is None:
        cq_wcb_borrow = torch.ones(C, dtype=torch.bool, device=dev)
    if cq_wcp_preempt is None:
        cq_wcp_preempt = torch.zeros(C, dtype=torch.bool, device=dev)
    if start_slot is None:
        start_slot = torch.zeros(W, dtype=torch.int32, device=dev)
    cq_avail_fn, classify_fn = _phase1_fns(plain)[:2]
    avail0, potential0 = cq_avail_fn(usage0, subtree, guaranteed,
                                     borrow_cap, has_blim, parent,
                                     n_cqs=C, depth=depth)
    out = classify_fn(wl_cq, wl_requests, start_slot, slot_fr, slot_valid,
                      nominal_cq, usage0, subtree, parent,
                      cq_can_preempt_borrow, cq_wcb_borrow, cq_wcp_preempt,
                      avail0, potential0, pairs=pairs)
    # the jit boundary: JAX runs without x64, so float64 becomes float32
    return out, wl_timestamp.to(torch.float32)


def _scan_outputs(admitted, fit_slot0, borrows0, preempt0):
    slots = torch.where(admitted, fit_slot0, -1).to(torch.int32)
    return admitted, slots, borrows0 & admitted, preempt0, fit_slot0, \
        borrows0


def _solve_cycle(args, cq_wcb_borrow, cq_wcp_preempt, start_slot, depth,
                 run_scan, plain):
    if len(args) != 14:
        raise TypeError(f"solve_cycle takes 14 positional planes, got "
                        f"{len(args)}")
    (fit_slot0, borrows0, preempt0, *pairs), ts = _phase1(
        args, cq_wcb_borrow, cq_wcp_preempt, start_slot, depth, run_scan,
        plain)
    if not run_scan:
        W = fit_slot0.shape[0]
        zeros_b = torch.zeros(W, dtype=torch.bool, device=fit_slot0.device)
        return (zeros_b, torch.full_like(fit_slot0, -1), zeros_b, preempt0,
                fit_slot0, borrows0)
    _, _, order_fn, scan_fn, _ = _phase1_fns(plain)
    usage0, subtree, guaranteed, borrow_cap, has_blim, parent, nominal_cq = \
        args[:7]
    dec_fr, dec_amt, fit_mask = pairs
    order = order_fn(borrows0, args[12], ts)
    no_reserve = torch.zeros_like(fit_mask)
    admitted = scan_fn(usage0, subtree, guaranteed, borrow_cap, has_blim,
                       parent, nominal_cq, torch.zeros_like(nominal_cq),
                       args[10], dec_fr, dec_amt, fit_mask,
                       torch.full_like(dec_fr, -1), torch.zeros_like(dec_amt),
                       no_reserve, no_reserve, order, depth=depth)
    return _scan_outputs(admitted, fit_slot0, borrows0, preempt0)


def _solve_cycle_forests(args, forest_of_node, depth, n_forests,
                         max_forest_wl, plain):
    if len(args) != 14:
        raise TypeError(f"solve_cycle_forests takes 15 positional planes, "
                        f"got {len(args) + 1}")
    (fit_slot0, borrows0, preempt0, dec_fr, dec_amt, fit_mask), ts = _phase1(
        args, None, None, None, depth, True, plain)
    _, _, order_fn, _, forests_fn = _phase1_fns(plain)
    order = order_fn(borrows0, args[12], ts)
    no_reserve = torch.zeros_like(fit_mask)
    nominal_cq = args[6]
    admitted = forests_fn(*args[:7], torch.zeros_like(nominal_cq), args[10],
                          dec_fr, dec_amt, fit_mask,
                          torch.full_like(dec_fr, -1),
                          torch.zeros_like(dec_amt), no_reserve, no_reserve,
                          order, forest_of_node, depth=depth,
                          n_forests=n_forests, max_forest_wl=max_forest_wl)
    return _scan_outputs(admitted, fit_slot0, borrows0, preempt0)


def solve_cycle_plain(*args, cq_wcb_borrow=None, cq_wcp_preempt=None,
                      start_slot=None, depth: int, run_scan: bool = True):
    """``solve_cycle`` through the plain versions only (any device)."""
    args, fung = _split_fungibility(args, cq_wcb_borrow, cq_wcp_preempt,
                                    start_slot)
    return _solve_cycle(args, *fung, depth, run_scan, plain=True)


def solve_cycle_forests_plain(*args, depth: int, n_forests: int,
                              max_forest_wl: int):
    """``solve_cycle_forests`` through the plain versions only."""
    return _solve_cycle_forests(args[:-1], args[-1], depth, n_forests,
                                max_forest_wl, plain=True)


def _split_fungibility(args, cq_wcb_borrow, cq_wcp_preempt, start_slot):
    """The JAX signature's optional 15th-17th positionals."""
    extra = list(args[14:]) + [None] * 3
    fung = [kw if kw is not None else pos for kw, pos in
            zip((cq_wcb_borrow, cq_wcp_preempt, start_slot), extra[:3])]
    return args[:14], fung


def solve_cycle(*args, cq_wcb_borrow=None, cq_wcp_preempt=None,
                start_slot=None, depth: int, run_scan: bool = True):
    """The one-call cycle solver (the JAX package's cycle.py:429).

    args: (usage0, subtree, guaranteed, borrow_cap, has_blim, parent,
    nominal_cq, slot_fr, slot_valid, cq_can_preempt_borrow, wl_cq,
    wl_requests, wl_priority, wl_timestamp[, cq_wcb_borrow,
    cq_wcp_preempt, start_slot]) as tensors on one device (the
    timestamp in any float dtype: it is cast to float32 first, as the JAX
    jit boundary casts it).  Returns (admitted [W] bool, slot [W] int32,
    borrows [W] bool, preempt_possible [W] bool, fit_slot0 [W] int32,
    borrows0 [W] bool); with ``run_scan=False`` only phase 1 runs and the
    first three are False / -1.  CUDA tensors launch ``kq_cq_avail``,
    ``kq_classify_heads`` and, with the scan, ``kq_cycle_order`` and
    ``admit_scan``; CPU tensors run the plain versions."""
    _route(args[0])
    args, fung = _split_fungibility(args, cq_wcb_borrow, cq_wcp_preempt,
                                    start_slot)
    return _solve_cycle(args, *fung, depth, run_scan, plain=False)


def solve_cycle_forests(*args, depth: int, n_forests: int,
                        max_forest_wl: int):
    """Phase 1 + the forest-parallel admit scan (the JAX package's
    cycle.py:649): args as ``solve_cycle``'s 14 planes plus
    ``forest_of_node`` [N] int32; the six outputs of ``solve_cycle``.
    CUDA tensors launch ``kq_cq_avail``, ``kq_classify_heads``,
    ``kq_cycle_order`` and ``admit_scan_forests``."""
    _route(args[0])
    return _solve_cycle_forests(args[:-1], args[-1], depth, n_forests,
                                max_forest_wl, plain=False)
