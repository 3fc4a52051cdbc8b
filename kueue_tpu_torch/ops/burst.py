"""Fused multi-cycle admission bursts: K scheduling cycles in ONE launch.

The per-cycle path pays its host plane and one kernel launch every
cycle.  The burst keeps the WHOLE pending set on the device (not just
the cycle heads) and fuses K successive cycles — head selection,
classify, preemption, admit scan, usage release and re-heads — into one
launch, so the launch cost is paid once per K cycles (reference hot loop
scheduler.go:176-302).

Semantics reproduced per fused cycle, bit-matching the host scheduler:

1. **Heads** (queue/manager.go:586 Heads): the top of every CQ's heap —
   an argmin over a dense per-CQ rank matrix.  Ranks are host-precomputed
   with the exact heap comparator (priority desc, queue-order timestamp
   asc, key asc — cluster_queue.go:408); they are static within a burst
   because priorities/timestamps never change without an external event,
   and external events end the burst.
2. **Classify** (flavorassigner.go:499): the vectorized nominate of
   ops.cycle.classify_np, evaluated dense over [C, S, R], with the
   FlavorFungibility walk from each head's carried resume slot.
3. **Cycle order** (scheduler.go:567 entryOrdering): borrows asc, then a
   host-precomputed (priority desc, timestamp asc, heads-position) rank.
4. **Admit scan** (scheduler.go:211-284): forest-parallel — one head per
   cohort forest per step, fits re-checked chain-locally, usage charged
   up the ancestor chain.
5. **Requeue semantics** (cluster_queue.go:225): a NoFit head parks in
   the inadmissible lot (BestEffortFIFO) or stays eligible (StrictFIFO);
   a fit head that lost capacity in-scan requeues immediately.
6. **Finish + unpark** (manager.go:490 QueueInadmissibleWorkloads): quota
   released at end-of-cycle unparks every CQ in the affected cohort
   forest.  Releases come from workloads admitted IN the burst finishing
   ``runtime`` cycles later and from an external release schedule.

Preemption is decided in-kernel inside a modeled envelope (candidate
discovery, candidatesOrdering, plan_searches' staged specs, the greedy
walk with fill-back, the scan-time overlap discipline); a head outside
it, or outside the vectorized classify's coverage, makes the cycle
**dirty** and the driver decides that cycle on the per-cycle path.

Usage invariant that makes device-resident state exact: for every cohort
node, ``usage[node] == Σ_children max(0, usage[child] - guaranteed
[child])`` (resource_node.go:123-144), so the kernel keeps only CQ-level
usage as ground truth and rebuilds cohort rows level by level.

``burst_cycles`` launches the hand-written CUDA kernel
(``kernels/burst_cycles.cu``) for CUDA tensors and runs
``burst_cycles_plain``, its plain PyTorch version, for CPU tensors.  The
host half (``pack_burst`` and the delta packs) is the JAX package's
numpy code, unchanged; ``BurstSolver`` launches on its device — on
"cuda" the burst runs on the card or raises.  ``set_shards(n)`` splits
the cohort forests over a burst mesh (``parallel.sharded``): one launch
per shard, the dirty flags reduced across shards, and the row planes of
a fresh pack kept on the mesh between windows, its dirty rows written by
``parallel.sharded.scatter_rows``.
"""

from __future__ import annotations

import itertools
import os
import sys
import time
import weakref

from dataclasses import dataclass

import numpy as np
import torch

from ..chaos import injector as _chaos
from ..features import env_value
from .quota_kernel import available_all

INF_I32 = np.int32(2**31 - 1)
I32_MAX = 2**31 - 1
# composite in-forest ordering key: borrows (entryOrdering's primary) in
# bit 30, the host-precomputed (priority, timestamp, position) rank below
_BORROW_BIT = np.int32(1 << 30)


# ----------------------------------------------------------------------
# The fused kernel
# ----------------------------------------------------------------------

# kind codes in the per-cycle decision output
KIND_NONE = 0
KIND_ADMIT = 1
KIND_SKIP = 2          # fit at nominate, lost capacity in-scan
KIND_PARK = 3          # NoFit (BestEffortFIFO parks; reserve parks too)
KIND_PREEMPT = 4       # preempting entry: issue evictions for targets
KIND_RESERVE = 5       # preempt-classified, no targets: reserve + requeue
KIND_OVERLAP_SKIP = 6  # overlapping preemption targets (scheduler.go:235)
KIND_PRE_NOFIT = 7     # preempt entry no longer fits in-scan

# dirty-reason bits (per burst cycle)
DIRTY_PREEMPT = 1      # preempt head outside the modeled envelope
DIRTY_SCALAR = 2       # head outside vectorized-classify coverage
DIRTY_RESUME = 4       # head with fungibility resume state



# ----------------------------------------------------------------------
# The fused kernel: plain PyTorch version
# ----------------------------------------------------------------------

_I32 = torch.int32
# planes the launch may narrow (packing.TIGHTEN_PLANES); the kernel and
# its plain version take them in any integer width
NARROW_ARGS = ("wl_req", "wl_cycle_rank", "wl_prio", "wl_uidrank",
                "parent", "node_level", "nominal_cq", "slot_fr",
                "forest_of_cq", "members", "cand_rows", "cand_lmem",
                "self_lmem")
# the positional arguments of burst_cycles, in order
ARG_NAMES = (
    "wl_req", "wl_rank", "wl_cycle_rank", "wl_prio", "wl_uidrank",
    "vec_ok", "elig0", "parked0", "resume0", "adm0", "adm_seq0",
    "adm_usage0", "adm_uses0", "death0", "seq_base", "u_cq0",
    "potential0", "subtree", "guaranteed", "borrow_cap", "has_blim",
    "parent", "node_level", "nominal_cq", "npb_cq", "slot_fr",
    "slot_valid", "cq_can_preempt_borrow", "cq_wcb_borrow",
    "cq_wcp_preempt", "forest_of_cq", "strict_cq", "wcq_lower",
    "rwc_enabled", "rwc_only_lower", "preempt_ok", "members", "cand_rows",
    "cand_lmem", "self_lmem", "ext_release", "ext_unpark")
STATE_NAMES = ("elig0", "parked0", "resume0", "adm0", "adm_seq0",
               "adm_usage0", "adm_uses0", "death0", "u_cq0")


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 → the int32 value with the same low 32 bits (XLA's
    wrapping int32 arithmetic, done in int64 where torch's int32 shifts
    would be undefined on overflow)."""
    return ((x + 2**31) & 0xFFFFFFFF) - 2**31


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """argmax of a bool mask along the last axis: the first True, 0 when
    none (jnp.argmax's first-occurrence rule)."""
    return mask.to(torch.uint8).argmax(-1)


def _pack_words(bits: torch.Tensor) -> torch.Tensor:
    """[..., KC] bool → [..., KC/32] int32 holding the uint32 bit words
    (bit b of word w = slot 32w + b)."""
    *lead, kc = bits.shape
    w = bits.reshape(*lead, kc // 32, 32).long() << torch.arange(
        32, device=bits.device)
    return _wrap32(w.sum(-1)).to(_I32)


def burst_cycles_plain(
        wl_req, wl_rank, wl_cycle_rank, wl_prio, wl_uidrank, vec_ok,
        elig0, parked0, resume0, adm0, adm_seq0, adm_usage0, adm_uses0,
        death0, seq_base, u_cq0, potential0, subtree, guaranteed,
        borrow_cap, has_blim, parent, node_level, nominal_cq, npb_cq,
        slot_fr, slot_valid, cq_can_preempt_borrow, cq_wcb, cq_wcp,
        forest_of_cq, strict_cq, wcq_lower, rwc_enabled, rwc_only_lower,
        preempt_ok, members, cand_rows, cand_lmem, self_lmem, ext_release,
        ext_unpark, *, K: int, depth: int, L: int, S: int, KC: int,
        n_levels: int, G: int, runtime: int, dflags_out: bool = False,
        dflags=None):
    """K fused admission cycles with in-kernel preemption, in plain
    PyTorch (kueue_tpu/ops/burst.py ``_burst_cycles``).

    Takes the JAX kernel's arguments (shapes in ``ARG_NAMES`` order:
    workload planes [C, M(, R/F)], quota [N, F], members [G, L],
    candidate tables [G, KC], events [K, C, F] / [K, G]) and returns
    ``(head_row [K,C], kind [K,C], slot [K,C], borrows [K,C] bool,
    tgt_words [K,C,KC/32], dirty [K] bool, dirty_reason [K], carry)``,
    int32 unless noted.  ``tgt_words`` holds the uint32 bit words as
    int32 (the same bits); ``carry`` is the final (elig, parked, resume,
    adm, adm_seq, adm_usage, adm_uses, death, u_cq).  With ``dflags_out``
    the [K, 4] int32 flag block (``dirty_flags``' input: one forest
    shard's part of the window's flags) replaces dirty and dirty_reason,
    written into ``dflags`` when given (a zeroed row of the sharded
    burst's window).

    The greedy and fill-back preemption walks run per lane: a lane stops
    once it fitted or walked past its eligible candidates (which sort
    first), and the fill-back starts below its own last taken position.
    The JAX loops run to a bound shared by all lanes; the extra steps
    take and drop nothing, so both give the same outputs."""
    dev = wl_req.device
    i64 = torch.long
    wl_req = wl_req.to(_I32)
    wl_cycle_rank = wl_cycle_rank.to(_I32)
    wl_prio = wl_prio.to(_I32)
    wl_uidrank = wl_uidrank.to(_I32)
    parent = parent.to(i64)
    node_level = node_level.to(i64)
    nominal_cq = nominal_cq.to(_I32)
    slot_fr = slot_fr.to(i64)
    forest_of_cq = forest_of_cq.to(i64)
    members = members.to(i64)
    cand_rows = cand_rows.to(i64)
    cand_lmem = cand_lmem.to(i64)
    self_lmem = self_lmem.to(i64)
    seq_base = int(seq_base)
    C, M, R = wl_req.shape
    N, F = subtree.shape
    INF = I32_MAX
    cidx = torch.arange(C, device=dev)
    has_parent_cq = parent[:C] >= 0
    sq_cq = subtree[:C]
    g_cq = guaranteed[:C]
    sq_root = subtree[parent[:C].clamp(min=0)]
    slot_cnt = slot_valid.sum(1)

    # per-CQ candidate tables (gathered per forest)
    crows = cand_rows[forest_of_cq]                     # [C, KC]
    cvalid = crows >= 0
    crs = crows.clamp(min=0)
    cci = crs // M
    cmi = crs % M
    clm = cand_lmem[forest_of_cq]
    same_cq = cvalid & (cci == cidx[:, None])
    c_prio = wl_prio[cci, cmi]
    c_uid = wl_uidrank[cci, cmi]
    memC = members[forest_of_cq]                        # [C, L]
    mem_valid = memC >= 0
    memCs = memC.clamp(min=0)
    g_mem = torch.where(mem_valid[:, :, None], guaranteed[memCs], 0)
    lane_oh = torch.arange(L, device=dev)[None, :] == self_lmem[:, None]
    parent_safe = parent.clamp(min=0)

    def rebuild_usage(u):
        """CQ usage → full node usage via the subtree invariant."""
        usage = torch.zeros((N, F), dtype=_I32, device=dev)
        usage[:C] = u
        for lvl in range(n_levels - 1, 0, -1):
            is_l = (node_level == lvl) & (parent >= 0)
            contrib = torch.where(is_l[:, None],
                                  (usage - guaranteed).clamp(min=0), 0)
            usage = usage.index_add(0, parent_safe, contrib.to(_I32))
        return usage

    def avail_from_members(u_mem):
        """available() at every CQ from its forest's member usage rows
        ([..., C, L, F]): the depth <= 2 form of available_at."""
        over = torch.where(mem_valid[..., None],
                           (u_mem - g_mem).clamp(min=0), 0)
        root_avail = sq_root - over.sum(-2, dtype=_I32)
        u_self = (u_mem * lane_oh[..., None]).sum(-2, dtype=_I32)
        local = (g_cq - u_self).clamp(min=0)
        blim_cap = borrow_cap[:C] - (u_self - g_cq).clamp(min=0)
        par_avail = torch.where(has_blim[:C],
                                torch.minimum(blim_cap, root_avail),
                                root_avail)
        return (torch.where(has_parent_cq[:, None], local + par_avail,
                            sq_cq - u_self), u_self)

    elig, parked, resume = elig0.clone(), parked0.clone(), resume0.clone()
    adm, adm_seq = adm0.clone(), adm_seq0.clone()
    adm_usage, adm_uses = adm_usage0.clone(), adm_uses0.clone()
    death, u_cq = death0.clone(), u_cq0.clone()
    outs = []
    for k in range(K):
        usage = rebuild_usage(u_cq)
        avail = available_all(usage, subtree, guaranteed, borrow_cap,
                              has_blim, parent, depth)

        # -- heads: argmin heap rank per CQ (first index on ties) -----
        key = torch.where(elig, wl_rank, INF)
        row = key.argmin(1)
        has_head = key[cidx, row] < INF
        req = wl_req[cidx, row]                                # [C, R]
        prio_head = wl_prio[cidx, row]

        # -- classify (classify_np dense twin) ------------------------
        frs_safe = slot_fr.clamp(min=0)
        covered = slot_fr >= 0
        reqb = req[:, None, :]
        needed = reqb > 0
        missing = (needed & ~covered).any(2)                   # [C,S]
        ci3 = cidx[:, None, None]
        av = avail[:C][ci3, frs_safe]                          # [C,S,R]
        pot = potential0[:C][ci3, frs_safe]
        nom = nominal_cq[ci3, frs_safe]
        use = usage[:C][ci3, frs_safe]
        sq = subtree[:C][ci3, frs_safe]
        relevant = covered & needed
        fit_r = reqb <= av
        nofit_r = reqb > pot
        preempt_capable_r = ((reqb <= nom)
                             | cq_can_preempt_borrow[:, None, None])
        res_nofit = relevant & (nofit_r | (~fit_r & ~preempt_capable_r))
        fit_s = (torch.where(relevant, fit_r, True).all(2) & ~missing
                 & slot_valid)
        nofit_s = res_nofit.any(2) | missing | ~slot_valid
        preempt_s = ~fit_s & ~nofit_s
        borrows_s = ((relevant & (use + reqb > sq)).any(2)
                     & has_parent_cq[:, None])

        # -- fungibility walk (flavorassigner.go:326-391) -------------
        start = resume[cidx, row]
        active_s = torch.arange(S, device=dev)[None, :] >= start[:, None]
        stop_s = (active_s & (fit_s | (preempt_s & cq_wcp[:, None]))
                  & (~borrows_s | cq_wcb[:, None]))
        has_stop = stop_s.any(1)
        act_mode = torch.where(active_s & fit_s, 2,
                               torch.where(active_s & preempt_s, 1, 0))
        best_mode = act_mode.max(1).values
        best_idx = _first_true((act_mode == best_mode[:, None]) & active_s)
        chosen = torch.where(has_stop, _first_true(stop_s), best_idx)
        chosen_mode = act_mode[cidx, chosen]
        has_fit = (chosen_mode == 2) & has_head
        fit_slot = torch.where(has_fit, chosen, -1)
        borrows = borrows_s[cidx, chosen] & has_fit
        has_preempt = (chosen_mode == 1) & has_head
        tried_c = torch.where(has_stop & (chosen < slot_cnt - 1), chosen, -1)
        pending_c = tried_c >= 0

        # -- preempt head facts on the chosen preempt slot ------------
        p_idx = chosen
        p_count = (preempt_s & active_s).sum(1)
        p_borrows = borrows_s[cidx, p_idx] & has_preempt
        pfrs = slot_fr[cidx, p_idx]                            # [C, R]
        prel = (pfrs >= 0) & (req > 0)
        pfrs_s = pfrs.clamp(min=0)
        pfit_r = fit_r[cidx, p_idx]
        ci2 = cidx[:, None].expand(C, R)
        frs_need = torch.zeros((C, F), dtype=_I32, device=dev).index_put_(
            (ci2, pfrs_s), (prel & ~pfit_r).to(_I32), accumulate=True) > 0
        wu = torch.zeros((C, F), dtype=_I32, device=dev).index_put_(
            (ci2, pfrs_s), torch.where(prel, req, 0).to(_I32),
            accumulate=True)
        pre_model = (has_preempt & preempt_ok
                     & (has_stop | (p_count == 1)))
        vec_head = vec_ok[cidx, row]
        dirty_c = has_head & ((has_preempt & ~pre_model) | ~vec_head)
        cycle_flags = (bool(dirty_c.any()),
                       bool((has_preempt & ~pre_model).any()),
                       bool((has_head & ~vec_head).any()))

        # -- nominate-time preemption searches (preemption.go:127-342) -
        preempting0 = torch.zeros(C, dtype=torch.bool, device=dev)
        tgt0 = torch.zeros((C, KC), dtype=torch.bool, device=dev)
        if bool(pre_model.any()):
            c_adm = adm[cci, cmi] & cvalid
            c_seq = adm_seq[cci, cmi]
            c_usage = adm_usage[cci, cmi]                      # [C,KC,F]
            c_uses = adm_uses[cci, cmi]
            uses_needed = (c_uses & frs_need[:, None, :]).any(2)
            borrow_cq0 = u_cq > sq_cq
            b0 = ((frs_need[:, None, :] & borrow_cq0[cci]).any(2)
                  & has_parent_cq[cci])
            lower = c_prio < prio_head[:, None]
            elig_same = same_cq & wcq_lower[:, None] & lower
            elig_cross = (cvalid & ~same_cq & rwc_enabled[:, None] & b0
                          & (~rwc_only_lower[:, None] | lower))
            e_base = c_adm & uses_needed & (elig_same | elig_cross)
            has_cross = (e_base & ~same_cq).any(1)
            under_nom = torch.where(frs_need, u_cq < nominal_cq,
                                    True).all(1)
            e_same = e_base & same_cq
            # plan_searches (preemption.go:144-191, bwc == Never)
            staged = has_cross & under_nom
            m0 = torch.where(staged[:, None], e_base, e_same)
            m1 = staged[:, None] & e_same
            msk = torch.stack([m0, m1])                        # [2,C,KC]
            ab = torch.stack([~staged, torch.ones_like(staged)])
            # candidatesOrdering (preemption.go:591): the kernel's two
            # int32 composite keys, compared (hi, lo) as signed ints —
            # one int64 key, sorted stably like jnp.lexsort
            elig_any = m0 | m1
            pat = 0xFFFFFFFF
            inv_seq = _wrap32((1 << 20) - 1 - c_seq.long())
            key_hi = _wrap32(
                ((~elig_any).long() << 30) | (same_cq.long() << 29)
                | ((_wrap32(c_prio.long() + (1 << 20)) << 8) & pat)
                | ((inv_seq >> 12) & pat))
            key_lo = _wrap32((((inv_seq & 0xFFF) << 19) & pat)
                             | (c_uid.long() & pat))
            order = torch.sort(key_hi * 2**32 + (key_lo + 2**31), dim=1,
                               stable=True).indices            # [C, KC]

            u_mem = torch.where(mem_valid[:, :, None], u_cq[memCs], 0)
            u_mem = u_mem.expand(2, C, L, F).clone()
            need = wu > 0

            def fits_of(u_mem):
                availC, u_self = avail_from_members(u_mem)     # [2,C,F]
                ok = torch.where(need[None], wu[None] <= availC,
                                 True).all(-1)
                bblock = (~ab) & (need[None]
                                  & (u_self + wu[None] > sq_cq[None])
                                  ).any(-1)
                return ok & ~bblock                             # [2, C]

            def step_at(t):
                j = order[:, t]
                lm = clm[cidx, j]
                oh = torch.arange(L, device=dev)[None, :] == lm[:, None]
                return j, oh, c_usage[cidx, j]

            n_elig = elig_any.sum(1)
            spec_active = torch.stack([pre_model, pre_model & staged])
            fitted = torch.zeros((2, C), dtype=torch.bool, device=dev)
            take_t = torch.zeros((2, C, KC), dtype=torch.bool, device=dev)
            for t in range(KC):
                alive = spec_active & ~fitted & (t < n_elig)[None]
                if not bool(alive.any()):
                    break
                j, oh, usage_t = step_at(t)
                e_t = msk[:, cidx, j]
                u_cand = (u_mem * oh[None, :, :, None]).sum(-2, dtype=_I32)
                # live borrowing re-check for cross-CQ candidates
                # (preemption.go:309 within the greedy walk)
                live_b = (frs_need[None]
                          & (u_cand > sq_cq[cci[cidx, j]][None])).any(-1)
                take = (alive & e_t
                        & torch.where(~same_cq[cidx, j][None], live_b, True))
                u_mem = u_mem - (take[:, :, None, None]
                                 * oh[None, :, :, None]
                                 * usage_t[None, :, None, :])
                fitted = fitted | (take & fits_of(u_mem))
                take_t[:, :, t] = take
            keep = take_t & fitted[:, :, None]
            pos = torch.arange(KC, device=dev)
            lastpos = torch.where(keep, pos, -1).max(-1).values  # [2, C]
            # fill-back (preemption.go fillBackWorkloads): below each
            # lane's last taken position, re-add a target when the
            # preemptor still fits without it
            for t in range(int(lastpos.max()) - 1, -1, -1):
                j, oh, usage_t = step_at(t)
                cond = keep[:, :, t] & (t < lastpos)
                add = (oh[None, :, :, None] * usage_t[None, :, None, :])
                u_try = u_mem + cond[:, :, None, None] * add
                drop = cond & fits_of(u_try)
                u_mem = u_mem + drop[:, :, None, None] * add
                keep[:, :, t] &= ~drop
            # sorted positions → candidate slots
            take_j = torch.zeros_like(keep).scatter_(
                2, order[None].expand(2, C, KC), keep)
            use1 = ~fitted[0] & fitted[1]
            preempting0 = pre_model & (fitted[0] | fitted[1])
            tgt0 = (torch.where(use1[:, None], take_j[1], take_j[0])
                    & preempting0[:, None])
        reserve_c = pre_model & ~preempting0

        # -- cycle order within each forest (entryOrdering) -----------
        head_crank = wl_cycle_rank[cidx, row]
        entry_borrows = torch.where(has_fit, borrows, p_borrows)
        in_scan = has_fit | preempting0 | reserve_c
        fit_key = torch.where(
            in_scan,
            head_crank + torch.where(entry_borrows, int(_BORROW_BIT), 0).to(_I32),
            INF).to(_I32)
        mem_safe = members.clamp(min=0)
        keys_gl = torch.where(members >= 0, fit_key[mem_safe], INF)
        ord_gl = torch.argsort(keys_gl, dim=1, stable=True)
        mat = torch.where(keys_gl.gather(1, ord_gl) < INF,
                          mem_safe.gather(1, ord_gl), -1)      # [G, L]

        # -- admit scan: one entry per forest per step ----------------
        u_scan, u_check = u_cq.clone(), u_cq.clone()
        used = torch.zeros(C * M, dtype=torch.bool, device=dev)
        flags = torch.zeros((4, L, G), dtype=torch.bool, device=dev)
        for col in range(L):
            cqs = mat[:, col]
            valid_l = cqs >= 0
            cs = cqs.clamp(min=0)
            lane_pre = preempting0[cs] & valid_l
            lane_tgt = tgt0[cs] & lane_pre[:, None]            # [G, KC]
            rows_l = crows[cs].clamp(min=0)
            tci = rows_l // M
            overlap = (used[rows_l] & lane_tgt).any(1)
            act = lane_pre & ~overlap
            tgt_act = lane_tgt & act[:, None]
            tdelta = adm_usage[tci, rows_l % M]                # [G,KC,F]
            rem = torch.zeros((C, F), dtype=_I32, device=dev).index_put_(
                (tci.reshape(-1),),
                torch.where(tgt_act[:, :, None], tdelta, 0).reshape(-1, F)
                .to(_I32), accumulate=True)
            avail_row = available_all(
                rebuild_usage(u_check - rem), subtree, guaranteed,
                borrow_cap, has_blim, parent, depth)[cs]       # [G, F]
            # fit entry: fixed-slot re-check
            frs_l = slot_fr[cs, fit_slot[cs].clamp(min=0)]     # [G, R]
            amt_l = req[cs]
            frs_ls = frs_l.clamp(min=0)
            rel_l = (frs_l >= 0) & (amt_l > 0)
            fit_ok = torch.where(rel_l, amt_l <= avail_row.gather(1, frs_ls),
                                 True).all(1)
            admit = valid_l & has_fit[cs] & fit_ok
            delta = torch.zeros((G, F), dtype=_I32, device=dev).scatter_add(
                1, frs_ls, torch.where(rel_l & admit[:, None], amt_l,
                                       0).to(_I32))
            # preempting entry: fits after its targets are removed
            wuc = wu[cs]
            pre_ok = torch.where(wuc > 0, wuc <= avail_row, True).all(1)
            pre_now = act & pre_ok
            delta = delta + torch.where(pre_now[:, None], wuc, 0)
            # reserve entry (resourcesToReserve, scheduler:383)
            is_res = valid_l & reserve_c[cs]
            cur = u_scan[cs]
            res_b = torch.minimum(wuc, npb_cq[cs] - cur)
            res_n = torch.minimum(wuc, nominal_cq[cs] - cur).clamp(min=0)
            rdelta = torch.where(p_borrows[cs][:, None], res_b, res_n)
            delta = delta + torch.where(is_res[:, None] & (wuc > 0),
                                        rdelta, 0)
            charged = admit | pre_now | is_res
            add = torch.where(charged[:, None], delta, 0).to(_I32)
            u_scan = u_scan.index_add(0, cs, add)
            commit = tgt_act & pre_now[:, None]
            u_check = u_check - torch.zeros(
                (C, F), dtype=_I32, device=dev).index_put_(
                (tci.reshape(-1),),
                torch.where(commit[:, :, None], tdelta, 0).reshape(-1, F)
                .to(_I32), accumulate=True)
            used[rows_l[commit]] = True
            u_check = u_check.index_add(0, cs, add)
            flags[:, col] = torch.stack([admit, pre_now, act & ~pre_ok,
                                         overlap & lane_pre])
        flat_cq = mat.T.reshape(-1)
        fv = flat_cq >= 0

        def scatter_flag(cols):
            out = torch.zeros(C, dtype=torch.bool, device=dev)
            out[flat_cq[cols.reshape(-1) & fv]] = True
            return out

        admitted_c, preempting_c, pre_nofit_c, overlap_c = (
            scatter_flag(flags[i]) for i in range(4))

        # -- end-of-cycle state transitions ---------------------------
        afrs = slot_fr[cidx, fit_slot.clamp(min=0)]           # [C, R]
        arel = (afrs >= 0) & (req > 0) & admitted_c[:, None]
        afrs_s = afrs.clamp(min=0)
        adm_delta = torch.zeros((C, F), dtype=_I32, device=dev).scatter_add(
            1, afrs_s, torch.where(arel, req, 0).to(_I32))
        adm_uses_new = torch.zeros((C, F), dtype=_I32,
                                   device=dev).scatter_add(
            1, afrs_s, arel.to(_I32)) > 0
        skipped = has_fit & ~admitted_c
        # a reserve head whose walk stopped mid-list keeps pending
        # flavors: the host requeues it immediately, not parked
        park_new = (((has_head & ~has_fit & ~has_preempt & ~dirty_c)
                     | (reserve_c & ~pending_c)) & ~strict_cq)
        gone = admitted_c | park_new
        elig[cidx, row] = elig[cidx, row] & ~gone
        parked[cidx, row] = park_new | parked[cidx, row]
        keep_resume = skipped | (reserve_c & pending_c) | overlap_c | \
            pre_nofit_c
        head_start = torch.where(keep_resume & pending_c, tried_c + 1, 0)
        resume[cidx, row] = torch.where(has_head, head_start.to(_I32),
                                        resume[cidx, row])
        adm[cidx, row] = admitted_c | adm[cidx, row]
        adm_seq[cidx, row] = torch.where(
            admitted_c, _wrap32(torch.tensor(seq_base + k)).to(_I32),
            adm_seq[cidx, row])
        adm_usage[cidx, row] = torch.where(admitted_c[:, None], adm_delta,
                                           adm_usage[cidx, row])
        adm_uses[cidx, row] = torch.where(admitted_c[:, None], adm_uses_new,
                                          adm_uses[cidx, row])
        death_new = k + runtime if runtime > 0 else INF
        death[cidx, row] = torch.where(admitted_c, death_new,
                                       death[cidx, row]).to(_I32)

        # evictions: committed targets leave the table, release usage,
        # and requeue at their original heap rank
        used2 = used.reshape(C, M)
        rel_evict = (used2[:, :, None] * adm_usage).sum(1, dtype=_I32)
        adm &= ~used2
        elig |= used2
        death = torch.where(used2, INF, death).to(_I32)
        # modeled finishes: rows whose death is this cycle (eviction
        # wins when both land on the same cycle)
        due = adm & (death == k)
        rel_death = (due[:, :, None] * adm_usage).sum(1, dtype=_I32)
        adm &= ~due
        release = rel_evict + rel_death + ext_release[k]
        u_cq = u_cq + adm_delta - release
        released_forest = torch.zeros(G, dtype=torch.bool, device=dev)
        released_forest[forest_of_cq[(release > 0).any(1)]] = True
        back = parked & (ext_unpark[k] | released_forest)[forest_of_cq][:,
                                                                        None]
        elig |= back
        parked &= ~back

        # -- decision output ------------------------------------------
        kind = torch.zeros(C, dtype=_I32, device=dev)
        for mask, code in ((park_new, KIND_PARK), (skipped, KIND_SKIP),
                           (admitted_c, KIND_ADMIT),
                           (reserve_c, KIND_RESERVE),
                           (preempting_c, KIND_PREEMPT),
                           (overlap_c, KIND_OVERLAP_SKIP),
                           (pre_nofit_c, KIND_PRE_NOFIT)):
            kind[mask] = code
        slot_out = torch.where(has_fit, fit_slot,
                               torch.where(pre_model, p_idx, -1))
        borrows_out = torch.where(has_fit, borrows, p_borrows)
        outs.append((torch.where(has_head, row, -1).to(_I32), kind,
                     slot_out.to(_I32), borrows_out,
                     _pack_words(tgt0 & preempting_c[:, None]),
                     cycle_flags))
    head_row, kind, slot, borrows, tgt_words = (
        torch.stack([o[i] for o in outs]) for i in range(5))
    # the fourth lane (DIRTY_RESUME) stays 0, as in the JAX kernel
    flags = torch.tensor([o[5] + (False,) for o in outs], dtype=_I32,
                         device=dev).reshape(K, 4)
    dflags = flags if dflags is None else dflags.copy_(flags)
    carry = (elig, parked, resume, adm, adm_seq, adm_usage, adm_uses,
             death, u_cq)
    flags = (dflags,) if dflags_out else dirty_flags(dflags)
    return (head_row, kind, slot, borrows, tgt_words) + flags + (carry,)


def dirty_flags(dflags: torch.Tensor):
    """``(dirty [K] bool, dirty_reason [K] int32)`` of a window's [K, 4]
    int32 flag block (kueue_tpu/ops/burst.py:791-795): a lane is set
    where any shard set it."""
    hit = dflags > 0
    reason = (hit[:, 1].to(_I32) * DIRTY_PREEMPT
              + hit[:, 2].to(_I32) * DIRTY_SCALAR
              + hit[:, 3].to(_I32) * DIRTY_RESUME)
    return hit[:, 0].contiguous(), reason


def _route(t: torch.Tensor) -> bool:
    """True → CUDA kernel; False → plain version; else raise."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no burst kernel for device {t.device}")


def burst_cycles(*args, node_table=None, **kw):
    """The fused burst: the CUDA kernel (kernels/burst_cycles.cu) for
    CUDA tensors, ``burst_cycles_plain`` for CPU tensors.  Arguments and
    outputs as ``burst_cycles_plain``; ``node_table`` (CUDA only) is the
    kernel's per-forest node table from ``kernels.burst_node_table``,
    derived from the arguments when not given."""
    if _route(args[0]):
        from .. import kernels
        return kernels.burst_cycles(*args, node_table=node_table, **kw)
    return burst_cycles_plain(*args, **kw)


def build_members(forest_of_cq: np.ndarray, n_forests: int,
                  max_per_forest: int) -> np.ndarray:
    """Static [G, L] matrix of CQ indices per forest (-1 pad)."""
    members = np.full((n_forests, max_per_forest), -1, dtype=np.int32)
    fill = np.zeros(n_forests, dtype=np.int64)
    for ci, f in enumerate(forest_of_cq):
        f = int(f)
        if fill[f] < max_per_forest:
            members[f, fill[f]] = ci
            fill[f] += 1
    return members


# ----------------------------------------------------------------------
# Roofline probe (synthetic)
# ----------------------------------------------------------------------

_probe_cache: dict = {}


def burst_probe_args(C: int, M: int, R: int, K: int, runtime: int = 4):
    """The synthetic north-star-shaped burst of ``burst_probe``: the
    positional numpy arguments and the keyword sizes."""
    key = (C, M, R)
    if key not in _probe_cache:
        rng = np.random.default_rng(0)
        G = max(1, C // 5)
        N = C + G
        F = R
        parent = np.concatenate([
            C + (np.arange(C) % G), np.full(G, -1)]).astype(np.int32)
        node_level = np.concatenate([
            np.ones(C, np.int32), np.zeros(G, np.int32)])
        forest_of_cq = (np.arange(C) % G).astype(np.int32)
        subtree = np.full((N, F), 10**7, np.int32)
        guaranteed = np.full((N, F), 20_000, np.int32)
        guaranteed[C:] = 10**7
        borrow_cap = np.full((N, F), 2**25, np.int32)
        has_blim = np.zeros((N, F), bool)
        nominal_cq = np.full((C, F), 20_000, np.int32)
        slot_fr = np.tile(np.arange(R, dtype=np.int32), (C, 1, 1))
        slot_valid = np.ones((C, 1), bool)
        cpb = np.zeros(C, bool)
        strict = np.zeros(C, bool)
        members = build_members(forest_of_cq, G, 8)
        wl_req = rng.integers(200, 2000, (C, M, R)).astype(np.int32)
        wl_rank = np.argsort(rng.random((C, M))).astype(np.int32)
        wl_cycle_rank = rng.permutation(C * M).reshape(C, M).astype(np.int32)
        ones = np.ones((C, M), bool)
        zeros = np.zeros((C, M), bool)
        u_cq0 = np.zeros((C, F), np.int32)
        from .cycle import available_all_np
        potential0 = available_all_np(
            np.zeros((N, F), np.int64), subtree, guaranteed, borrow_cap,
            has_blim, parent, 2).astype(np.int32)
        _probe_cache[key] = dict(
            wl_req=wl_req, wl_rank=wl_rank, wl_cycle_rank=wl_cycle_rank,
            vec_ok=ones, elig0=ones, parked0=zeros, resume0=zeros,
            u_cq0=u_cq0, potential0=potential0, subtree=subtree,
            guaranteed=guaranteed, borrow_cap=borrow_cap,
            has_blim=has_blim, parent=parent, node_level=node_level,
            nominal_cq=nominal_cq, slot_fr=slot_fr,
            slot_valid=slot_valid, cq_can_preempt_borrow=cpb,
            forest_of_cq=forest_of_cq, strict_cq=strict, members=members,
            G=G)
    d = _probe_cache[key]
    G = d["G"]
    F = R
    ext_release = np.zeros((K, C, R), np.int32)
    ext_unpark = np.zeros((K, G), bool)
    L = 8
    KC = ((L * M + 31) // 32) * 32
    cand_rows, cand_lmem, self_lmem = build_candidate_tables(
        d["forest_of_cq"], d["members"], M, KC)
    zeros_cm = np.zeros((C, M), np.int32)
    args = (
        d["wl_req"], d["wl_rank"], d["wl_cycle_rank"],
        zeros_cm, zeros_cm,
        d["vec_ok"], d["elig0"], d["parked0"], zeros_cm,
        np.zeros((C, M), bool), zeros_cm,
        np.zeros((C, M, F), np.int32), np.zeros((C, M, F), bool),
        np.full((C, M), I32_MAX, np.int32), np.int32(1),
        d["u_cq0"],
        d["potential0"], d["subtree"], d["guaranteed"], d["borrow_cap"],
        d["has_blim"], d["parent"], d["node_level"], d["nominal_cq"],
        np.full((C, F), I32_MAX, np.int32),
        d["slot_fr"], d["slot_valid"],
        d["cq_can_preempt_borrow"],
        np.ones(C, bool), np.zeros(C, bool),
        d["forest_of_cq"], d["strict_cq"],
        np.zeros(C, bool), np.zeros(C, bool), np.zeros(C, bool),
        np.zeros(C, bool),
        d["members"], cand_rows, cand_lmem, self_lmem,
        ext_release, ext_unpark)
    kw = dict(K=K, depth=2, L=L, S=1, KC=KC, n_levels=2, G=G,
              runtime=runtime)
    return args, kw


def burst_probe(C: int, M: int, R: int, K: int, runtime: int = 4,
                device="cuda"):
    """One fused-burst launch on synthetic north-star-shaped data, on
    ``device`` (the CUDA kernel on "cuda", the plain version on
    "cpu").  Returns the output tensors on that device."""
    args, kw = burst_probe_args(C, M, R, K, runtime)
    dev = torch.device(device)
    return burst_cycles(*[a if isinstance(a, np.integer)
                          else torch.from_numpy(np.ascontiguousarray(a))
                          .to(dev) for a in args], **kw)


# ----------------------------------------------------------------------
# Host side: pack the live queue/cache state into a burst plan
# ----------------------------------------------------------------------

@dataclass
class BurstPlan:
    """Dense device state for one burst + the host maps to apply it."""
    structure: object                 # PackedStructure
    arrays: dict                      # kernel inputs (numpy)
    keys: list                        # [C][M] workload key or None
    C: int
    M: int
    L: int
    G: int
    n_levels: int
    KC: int = 0
    seq_base: int = 1
    row_of_key: dict = None           # key -> (ci, mi)
    max_res_ts: Optional[float] = None  # newest pre-burst reservation
    # shard-resident chaining (pack_burst_cached): the delta-pack state
    # tokens this plan consumed/produced and the CQ indices it re-walked.
    # A resident device copy of the PREVIOUS pack's rows is reusable iff
    # its token matches prev_token — then exactly dirty_cqs rows differ.
    pack_token: Optional[int] = None
    prev_token: Optional[int] = None
    dirty_cqs: Optional[np.ndarray] = None   # None = full walk
    dirty_ranges: Optional[list] = None      # coalesced [lo, hi) rows
    # head-pack accounting: rows charged against the kernel's 2^19
    # composite-key budget vs total rows packed into the [C, M] grid
    # (budget_rows == grid_rows when KUEUE_TPU_HEAD_PACK=0)
    budget_rows: int = 0
    grid_rows: int = 0


def build_candidate_tables(forest_of_cq: np.ndarray, members: np.ndarray,
                           M: int, KC: int):
    """Static preemption-candidate tables: for each forest the flattened
    row ids (cq*M+m) of every member CQ's rows, each row's member slot,
    and each CQ's own member slot."""
    G, L = members.shape
    C = len(forest_of_cq)
    cand_rows = np.full((G, KC), -1, dtype=np.int32)
    cand_lmem = np.zeros((G, KC), dtype=np.int32)
    self_lmem = np.zeros(C, dtype=np.int32)
    for g in range(G):
        j = 0
        for l in range(L):
            cq = int(members[g, l])
            if cq < 0:
                continue
            self_lmem[cq] = l
            n = min(M, KC - j)
            if n > 0:
                cand_rows[g, j:j + n] = cq * M + np.arange(n)
                cand_lmem[g, j:j + n] = l
            j += M
    return cand_rows, cand_lmem, self_lmem


def _static_row(info, st, covers_pods: bool, qts):
    """Per-Info static pack facts: (covers_pods, scaled request vector,
    static vectorized-eligibility, queue-order ts, priority, uid).
    Cached on the Info keyed by the structure generation — requests,
    conditions, and priority are immutable per Info instance (updates
    build a fresh Info — queue/manager.py add_or_update_workload)."""
    R = len(st.resource_names)
    scale = st.resource_scale
    obj = info.obj
    ok = (len(obj.pod_sets) == 1
          and obj.pod_sets[0].topology_request is None
          and not any(ps.min_count is not None and ps.min_count < ps.count
                      for ps in obj.pod_sets))
    exact = True
    acc = np.zeros(R, dtype=np.int64)
    for psr in info.total_requests:
        for r, v in psr.requests.items():
            if r == "pods" and not covers_pods:
                continue
            ri = st.r_index.get(r)
            if ri is None:
                exact = False
                continue
            if v < 0:
                exact = False
                v = 0
            if st.scale_is_one:
                acc[ri] += int(v)
            else:
                s = int(scale[ri])
                q_, rem = divmod(int(v), s)
                if rem:
                    exact = False
                    q_ += 1
                acc[ri] += q_
    if acc.max(initial=0) > I32_MAX:
        exact = False
        np.clip(acc, None, I32_MAX, out=acc)
    return (covers_pods, acc.astype(np.int32), ok and exact,
            qts(obj), obj.priority, obj.uid)


KC_CAP = 4096          # max candidate slots per forest (in-kernel preempt)


def admitted_usage_vec(info, st, scale_of: dict, F: int) -> Optional[tuple]:
    """(usage [F] int32, uses [F] bool) of an admitted Info, scaled into
    the packed structure's flavor-resource axis; None when not exactly
    representable.  Cached on the Info per (structure generation,
    reservation time) — the usage map is stable per admission, and both
    re-packs and the driver's finish-schedule fill walk every admitted
    workload."""
    from ..api.types import WL_QUOTA_RESERVED
    cond = info.obj.conditions.get(WL_QUOTA_RESERVED)
    ts = cond.last_transition_time if cond is not None else -1.0
    gen = st.generation
    hit = getattr(info, "_burst_usage", None)
    if hit is not None and hit[0] == gen and hit[1] == ts:
        return hit[2]
    vec = np.zeros(F, dtype=np.int64)
    uses = np.zeros(F, dtype=bool)
    out = None
    ok = True
    for fr, v in info.usage().items():
        fi = st.fr_index.get(fr)
        s = scale_of.get(fr.resource) if fi is not None else None
        if fi is None or s is None or v % s:
            ok = False
            break
        vec[fi] += v // s
        uses[fi] = True
    if ok and vec.max(initial=0) <= I32_MAX:
        out = (vec.astype(np.int32), uses)
    info._burst_usage = (gen, ts, out)
    return out


_PACK_FAIL = object()   # sentinel: this CQ fails the whole pack


class _CQRows:
    """One CQ's packed rows (pending then admitted) plus the per-CQ
    facts stage B needs.  Records are the unit of delta reuse: a clean
    record re-enters ``_assemble_plan`` untouched while a dirty CQ
    re-walks into a fresh record.  Row order within a record never
    reaches the plan — every stage-B rank comes from a total-order
    lexsort with a unique final tiebreak — so reuse stays bit-identical
    even though a re-walk may enumerate members differently.

    ``n_comp`` / ``comp_max_ts`` account for admitted rows of
    compressible forests (ops/aggregate.py) that were walked but NOT
    packed: their count and max reservation time are all the plan
    needs from them (usage is already in ``u_row``)."""
    __slots__ = ("ci", "pos", "strict", "bad", "truncated",
                 "n_pend", "n_adm", "n_comp", "comp_max_ts",
                 "keys", "uids", "prio", "ts",
                 "res_ts", "parked", "ok", "resume", "adm", "req",
                 "usage", "uses", "u_row", "index_of_key", "infos")

    @property
    def n_rows(self) -> int:
        return self.n_pend + self.n_adm


class _PackStatics:
    """Structure-keyed stage-B tables: tree levels, forest membership,
    preemption-policy flags and the zero-usage potential — all pure
    functions of the packed structure (CQ/cohort spec edits bump the
    structure generation), memoized on the structure object so re-packs
    and delta packs skip the O(N·depth) Python walks."""
    __slots__ = ("forest_of_cq", "node_level", "n_levels", "L",
                 "members", "deep", "wcq_lower", "rwc_enabled",
                 "rwc_only_lower", "modelable_base", "potential0",
                 "comp_cq", "cand_tables")


def _pack_statics(st, cache) -> _PackStatics:
    s = getattr(st, "_burst_statics", None)
    if s is not None:
        return s
    from ..api.types import (BorrowWithinCohortPolicy,
                             ReclaimWithinCohort, WithinClusterQueue)
    from .cycle import available_all_np
    C = len(st.cq_names)
    F = max(1, len(st.fr_index))
    G = st.n_forests
    N = st.node_count
    parent = st.parent
    s = _PackStatics()
    s.cand_tables = {}
    s.forest_of_cq = st.forest_of_node[:C].astype(np.int32)
    node_level = np.zeros(N, dtype=np.int32)
    for ni in range(N):
        lvl, p = 0, parent[ni]
        while p >= 0:
            lvl += 1
            p = parent[p]
        node_level[ni] = lvl
    # node_level[ni] = distance from root (roots = 0); rebuild_usage
    # sweeps deepest levels first via range(n_levels-1, 0, -1)
    s.node_level = node_level
    s.n_levels = int(node_level.max()) + 1
    per_forest = np.bincount(s.forest_of_cq, minlength=G)
    s.L = max(1, int(per_forest.max()))
    s.members = build_members(s.forest_of_cq, G, s.L)
    # forest depth > 2 (nested cohorts) is outside the envelope
    deep = np.zeros(G, dtype=bool)
    np.maximum.at(deep, s.forest_of_cq, node_level[:C] > 1)
    s.deep = deep
    wcq_lower = np.zeros(C, dtype=bool)
    rwc_enabled = np.zeros(C, dtype=bool)
    rwc_only_lower = np.zeros(C, dtype=bool)
    modelable_base = np.zeros(C, dtype=bool)
    for ci, name in enumerate(st.cq_names):
        cq_live = cache.cluster_queue(name)
        if cq_live is None:
            continue
        pol = cq_live.spec.preemption
        wcq_lower[ci] = (pol.within_cluster_queue
                         == WithinClusterQueue.LOWER_PRIORITY)
        rwc_enabled[ci] = (pol.reclaim_within_cohort
                           != ReclaimWithinCohort.NEVER)
        rwc_only_lower[ci] = (pol.reclaim_within_cohort
                              == ReclaimWithinCohort.LOWER_PRIORITY)
        modelable_base[ci] = (
            pol.borrow_within_cohort.policy
            == BorrowWithinCohortPolicy.NEVER
            and pol.within_cluster_queue
            != WithinClusterQueue.LOWER_OR_NEWER_EQUAL_PRIORITY)
    s.wcq_lower = wcq_lower
    s.rwc_enabled = rwc_enabled
    s.rwc_only_lower = rwc_only_lower
    s.modelable_base = modelable_base
    from .aggregate import compressible_cqs
    s.comp_cq = compressible_cqs(s)
    s.potential0 = np.minimum(available_all_np(
        np.zeros((N, F), np.int64), st.subtree_quota, st.guaranteed,
        st.borrow_cap, st.has_borrow_limit, st.parent, st.depth),
        np.int64(I32_MAX)).astype(np.int32)
    st._burst_statics = s
    return s


def _unknown_active_cq(st, queues) -> bool:
    """An active CQ with pending work the structure doesn't know about
    fails the pack (the kernel can't model it at all)."""
    known = st.cq_index
    for name in queues.cluster_queue_names():
        if name in known:
            continue
        q = queues.queue_for(name)
        if q is not None and q.active and q.pending_active():
            return True
    return False


def _pack_cq_rows(st, ci, pos, queues, cache, scheduler, assumed,
                  scale_of, window, compress=False):
    """Stage A for ONE ClusterQueue: walk its heap + parking lot and
    its admitted table into a _CQRows record, or _PACK_FAIL when the CQ
    can't be represented (missing from the cache, inexact usage
    scaling).

    With ``compress`` (CQ in a compressible forest + aggregate planes
    on) the admitted walk runs identically — same bad-detection, same
    usage-vector check, so ``rec.bad`` matches the uncompressed arm
    byte for byte — but representable admitted rows are folded into
    ``n_comp`` / ``comp_max_ts`` aggregates instead of packed rows."""
    from ..api.types import (QueueingStrategy, AdmissionCheckState,
                             WL_EVICTED, WL_QUOTA_RESERVED)
    from .packing import scaled_usage_row
    ordering = scheduler.ordering
    qts = ordering.queue_order_timestamp
    F = max(1, len(st.fr_index))
    R = len(st.resource_names)
    gen = st.generation
    cq_name = st.cq_names[ci]
    cq_live = cache.cluster_queue(cq_name)
    if cq_live is None:
        return _PACK_FAIL
    u_row = scaled_usage_row(st, cq_live)
    if u_row is None:
        return _PACK_FAIL

    rec = _CQRows()
    rec.ci = ci
    rec.pos = pos
    rec.bad = False
    rec.truncated = False
    rec.n_comp = 0
    rec.comp_max_ts = -np.inf

    q = queues.queue_for(cq_name)
    active = q is not None and q.active
    rec.strict = bool(
        active and q.queueing_strategy == QueueingStrategy.STRICT_FIFO)
    members = []
    parked_keys = set()
    if active:
        members.extend(q.heap.items())
        for key, info in q.inadmissible.items():
            rs = info.obj.requeue_state
            if rs is not None and rs.requeue_at is not None:
                # backoff-parked: excluded; a mid-burst expiry diverges
                # the heads and the application validator truncates
                continue
            members.append(info)
            parked_keys.add(info.key)

    if window > 0:
        cap = window + 2
        if len(members) > cap:
            import heapq

            def sel_key(info):
                # the tuple is rebuilt ~rows×windows times at scale;
                # cache it per structure generation alongside the row
                sel = getattr(info, "_burst_sel", None)
                if sel is not None and sel[0] == gen:
                    return sel[1]
                row = getattr(info, "_burst_row", None)
                if row is not None and row[0] == gen:
                    t = (-row[5], row[4], info.key)
                else:
                    obj = info.obj
                    t = (-obj.priority, qts(obj), info.key)
                info._burst_sel = (gen, t)
                return t

            members = heapq.nsmallest(cap, members, key=sel_key)
            rec.truncated = True

    admitted = []
    for key, info in cq_live.workloads.items():
        obj = info.obj
        # assumed-but-applied workloads are normal candidates (the
        # apply hook is synchronous here; a failed apply forgets the
        # assumption before the cycle returns) — only a live evicted
        # condition or a missing reservation breaks the modeled
        # candidate ordering
        if (obj.condition_true(WL_EVICTED)
                or obj.conditions.get(WL_QUOTA_RESERVED) is None):
            rec.bad = True
            continue
        admitted.append(info)

    covers_pods = cq_name in st.cq_covers_pods
    cq_ok = st.cq_vector_ok
    cq_vec = bool(cq_ok[ci]) if cq_ok is not None else False
    if cq_vec and cq_live.spec.namespace_selector:
        cq_vec = False   # selector evaluation stays on the host path
    lr_summaries = scheduler.limit_range_summaries

    n_upper = len(members) + len(admitted)
    prio_l: list[int] = []
    ts_l: list[float] = []
    res_ts_l: list[float] = []
    parked_l: list[bool] = []
    ok_l: list[bool] = []
    resume_l: list[int] = []      # flavor-walk start slot (0 = full)
    key_l: list[str] = []
    uid_l: list[str] = []
    infos: list = []
    req_mat = np.zeros((n_upper, R), dtype=np.int32)
    usage_mat = np.zeros((n_upper, F), dtype=np.int32)
    uses_mat = np.zeros((n_upper, F), dtype=bool)

    i = 0
    for info in members:
        row = getattr(info, "_burst_row", None)
        if row is None or row[0] != gen or row[1] != covers_pods:
            row = (gen, *_static_row(info, st, covers_pods, qts))
            info._burst_row = row
        _, _, req_vec, static_ok, ts, prio, uid = row
        key = info.key
        key_l.append(key)
        uid_l.append(uid)
        prio_l.append(prio)
        ts_l.append(ts)
        res_ts_l.append(0.0)
        parked_l.append(key in parked_keys)
        req_mat[i] = req_vec
        ok = cq_vec and static_ok
        if ok:
            obj = info.obj
            if lr_summaries and lr_summaries.get(obj.namespace):
                ok = False   # LimitRange bounds stay host-side
            elif key in assumed or obj.admission is not None:
                ok = False
            elif obj.admission_check_states and any(
                    stt.state in (AdmissionCheckState.RETRY,
                                  AdmissionCheckState.REJECTED)
                    for stt in obj.admission_check_states.values()):
                ok = False
        ok_l.append(ok)
        from .solver import resume_start
        resume_l.append(resume_start(info, cq_live, covers_pods))
        infos.append(info)
        i += 1
    rec.n_pend = i

    for info in admitted:
        uv = admitted_usage_vec(info, st, scale_of, F)
        if uv is None:
            # not representable as a target/release row: the host
            # handles its cycles (forest out of the envelope) and
            # its finish via the ext_release path
            rec.bad = True
            continue
        if compress:
            # never candidate-gathered (no preempting CQ in this
            # forest): fold into the aggregates; a mid-burst finish
            # reaches the kernel via the ext_release fallback exactly
            # as an unpacked key does today
            rec.n_comp += 1
            ts_r = info.obj.conditions[WL_QUOTA_RESERVED] \
                .last_transition_time
            if ts_r > rec.comp_max_ts:
                rec.comp_max_ts = ts_r
            continue
        row = getattr(info, "_burst_row", None)
        if row is None or row[0] != gen or row[1] != covers_pods:
            row = (gen, *_static_row(info, st, covers_pods, qts))
            info._burst_row = row
        _, _, req_vec, static_ok, ts, prio, uid = row
        key_l.append(info.key)
        uid_l.append(uid)
        prio_l.append(prio)
        ts_l.append(ts)
        parked_l.append(False)
        obj = info.obj
        cond = obj.conditions.get(WL_QUOTA_RESERVED)
        res_ts_l.append(cond.last_transition_time)
        req_mat[i] = req_vec
        usage_mat[i], uses_mat[i] = uv
        # post-eviction afterlife: the same dynamic gates pending
        # rows get (LimitRange bounds, failed admission checks) —
        # an in-burst-evicted row the kernel re-admits must honor
        # everything the host nominate would; gating extra is safe
        # (the cycle goes dirty), gating less diverges decisions
        ok = cq_vec and static_ok
        if ok:
            if lr_summaries and lr_summaries.get(obj.namespace):
                ok = False
            elif obj.admission_check_states and any(
                    stt.state in (AdmissionCheckState.RETRY,
                                  AdmissionCheckState.REJECTED)
                    for stt in obj.admission_check_states.values()):
                ok = False
        ok_l.append(ok)
        resume_l.append(0)
        infos.append(info)
        i += 1
    rec.n_adm = i - rec.n_pend

    rec.keys = (np.asarray(key_l) if key_l
                else np.empty(0, dtype="U1"))
    rec.uids = (np.asarray(uid_l) if uid_l
                else np.empty(0, dtype="U1"))
    rec.prio = np.array(prio_l, dtype=np.int64)
    rec.ts = np.array(ts_l, dtype=np.float64)
    rec.res_ts = np.array(res_ts_l, dtype=np.float64)
    rec.parked = np.array(parked_l, dtype=bool)
    rec.ok = np.array(ok_l, dtype=bool)
    rec.resume = np.array(resume_l, dtype=np.int32)
    adm = np.zeros(i, dtype=bool)
    adm[rec.n_pend:] = True
    rec.adm = adm
    rec.req = req_mat[:i]
    rec.usage = usage_mat[:i]
    rec.uses = uses_mat[:i]
    rec.u_row = u_row
    rec.index_of_key = {k: j for j, k in enumerate(key_l)}
    rec.infos = infos
    return rec


def _walk_records(st, queues, cache, scheduler, window):
    """Stage A over every CQ; None when any CQ fails the pack."""
    C = len(st.cq_names)
    # CQ-position order (the queue manager's heads enumeration order)
    pos_of = {name: i for i, name in
              enumerate(queues.cluster_queue_names())}
    assumed = cache.assumed_workloads
    scale_of = {r: int(st.resource_scale[i])
                for i, r in enumerate(st.resource_names)}
    from .aggregate import agg_planes_enabled
    s = _pack_statics(st, cache)
    comp_cq = s.comp_cq if agg_planes_enabled() else None
    records = []
    for ci in range(C):
        rec = _pack_cq_rows(st, ci, pos_of.get(st.cq_names[ci], C),
                            queues, cache, scheduler, assumed,
                            scale_of, window,
                            compress=(comp_cq is not None
                                      and bool(comp_cq[ci])))
        if rec is _PACK_FAIL:
            return None
        records.append(rec)
    return records


_ROW_ATTRS = ("adm", "prio", "ts", "res_ts", "parked", "ok",
              "resume", "req", "usage", "uses", "keys", "uids")


def _concat_row_fields(records, nz, prev):
    """Concatenate the per-record row arrays into flat stage-B fields.

    ``prev`` (previous record list + its concatenated fields, from the
    delta state) turns the 1000-segment concatenation into a few-chunk
    splice: runs of reused record objects slice the cached flat arrays
    (their rows are unchanged by construction), only re-walked records
    contribute fresh segments.  Returns (fields, bounds) with the same
    values a plain concatenation would produce."""
    chunks = None
    if prev is not None:
        prev_records, prev_fields = prev
        if prev_fields is not None and len(prev_records) == len(records):
            bounds = prev_fields["_bounds"]
            chunks = []          # (0, lo, hi) = prev slice; (1, i, 0)
            run = None
            for i, r in enumerate(records):
                if r is prev_records[i]:
                    if run is None:
                        run = [int(bounds[i]), int(bounds[i + 1])]
                    else:
                        run[1] = int(bounds[i + 1])
                else:
                    if run is not None:
                        chunks.append((0, run[0], run[1]))
                        run = None
                    if r.n_rows:
                        chunks.append((1, i, 0))
            if run is not None:
                chunks.append((0, run[0], run[1]))
    fields = {}
    if chunks is not None:
        for attr in _ROW_ATTRS:
            prev_arr = prev_fields[attr]
            fields[attr] = np.concatenate(
                [prev_arr[lo:hi] if tag == 0
                 else getattr(records[lo], attr)
                 for tag, lo, hi in chunks]) if chunks else prev_arr[:0]
    else:
        for attr in _ROW_ATTRS:
            fields[attr] = np.concatenate(
                [getattr(r, attr) for r in nz])
    n_rows_arr = np.fromiter((r.n_rows for r in records),
                             dtype=np.int64, count=len(records))
    fields["_bounds"] = np.concatenate(
        ([0], np.cumsum(n_rows_arr)))
    return fields


def _assemble_plan(st, records, cache, scheduler, min_m,
                   prev=None, fields_out=None):
    """Stage B: fuse per-CQ row records into the dense [C, M] plan.

    Pure vectorized numpy over the concatenated rows; every rank comes
    from a total-order lexsort (key/uid final tiebreaks), so the output
    is independent of record row order and a plan assembled from
    delta-refreshed records is bit-identical to a full re-walk of the
    same live state.  ``prev``/``fields_out`` carry the flat row arrays
    across windows for the delta path (see ``_concat_row_fields``)."""
    ordering = scheduler.ordering
    C = len(st.cq_names)
    F = max(1, len(st.fr_index))
    R = len(st.resource_names)
    n_pending = sum(r.n_pend for r in records)
    if n_pending == 0:
        return None
    s = _pack_statics(st, cache)
    G = st.n_forests
    forest_of_cq = s.forest_of_cq
    L = s.L
    node_level = s.node_level

    from .packing import _bucket
    # sticky minimum keeps M stable across re-packs as queues drain
    # (every distinct M is a fresh XLA compilation)
    rows_per_cq = max(r.n_rows for r in records)
    M = max(_bucket(rows_per_cq, minimum=4), min_m)

    nz = [r for r in records if r.n_rows > 0]
    fields = _concat_row_fields(records, nz, prev)
    if fields_out is not None:
        fields_out.update(fields)
    n_rows_arr = np.diff(fields["_bounds"])
    ci_a = np.repeat(
        np.fromiter((r.ci for r in records), dtype=np.int32, count=C),
        n_rows_arr)
    pos_a = np.repeat(
        np.fromiter((r.pos for r in records), dtype=np.int32, count=C),
        n_rows_arr)
    adm_a = fields["adm"]
    prio_a = fields["prio"]
    ts_a = fields["ts"]
    parked_a = fields["parked"]
    res_ts_a = fields["res_ts"]
    ok_a = fields["ok"]
    resume_a = fields["resume"]
    req_all = fields["req"]
    usage_all = fields["usage"]
    uses_all = fields["uses"]
    key_arr = fields["keys"]
    uid_arr = fields["uids"]
    n = int(fields["_bounds"][-1])
    strict = np.fromiter((r.strict for r in records), dtype=bool,
                         count=C)

    wl_req = np.zeros((C, M, R), dtype=np.int32)
    wl_rank = np.full((C, M), INF_I32, dtype=np.int32)
    wl_cycle_rank = np.zeros((C, M), dtype=np.int32)
    wl_prio = np.zeros((C, M), dtype=np.int32)
    wl_uidrank = np.zeros((C, M), dtype=np.int32)
    vec_ok = np.zeros((C, M), dtype=bool)
    elig = np.zeros((C, M), dtype=bool)
    parked = np.zeros((C, M), dtype=bool)
    resume = np.zeros((C, M), dtype=np.int32)
    adm = np.zeros((C, M), dtype=bool)
    adm_seq = np.zeros((C, M), dtype=np.int32)
    adm_usage = np.zeros((C, M, F), dtype=np.int32)
    adm_uses = np.zeros((C, M, F), dtype=bool)
    death = np.full((C, M), I32_MAX, dtype=np.int32)

    # heap rank within each CQ: one global lexsort replaces C Python
    # sorts (priority desc, queue-order ts asc, key asc —
    # cluster_queue.go:408).  Admitted rows get ranks too: a preempted
    # target re-enters the heap at exactly this position (preemption
    # evictions keep the creation-time ordering, workload.py:309).
    order = np.lexsort((key_arr, ts_a, -prio_a, ci_a))
    ci_sorted = ci_a[order]
    first = np.ones(n, dtype=bool)
    first[1:] = ci_sorted[1:] != ci_sorted[:-1]
    seg_start = np.maximum.accumulate(
        np.where(first, np.arange(n), 0))
    mi_sorted = (np.arange(n) - seg_start).astype(np.int64)
    mi_a = np.empty(n, dtype=np.int64)
    mi_a[order] = mi_sorted
    # global cycle-order rank (priority desc, ts asc, heads-position);
    # the key tiebreak keeps the rank independent of heap-array order
    # (pops/pushes permute heap.items()), which delta reuse requires
    crank = np.empty(n, dtype=np.int64)
    crank[np.lexsort((key_arr, pos_a, ts_a, -prio_a))] = np.arange(n)
    # uid rank (candidatesOrdering final tiebreak) + reservation-time
    # dense rank (ties share a value; uid breaks them separately).
    # Head-pack mode scopes the rank to budget rows — rows of forests
    # that can preempt (~comp_cq); the rest can never be candidate-
    # gathered (see aggregate.head_pack_enabled), so their uidrank
    # cells are never read and the subset rank preserves the eligible
    # ordering bit for bit while freeing the 19-bit field's range.
    from .aggregate import head_pack_enabled
    head_pack = head_pack_enabled()
    uidrank = np.zeros(n, dtype=np.int64)
    if head_pack:
        bidx = np.nonzero(~s.comp_cq[ci_a])[0]
        uidrank[bidx[np.argsort(uid_arr[bidx], kind="stable")]] = \
            np.arange(len(bidx))
        n_budget = int(len(bidx))
        prio_budget = (int(np.abs(prio_a[bidx]).max()) if n_budget else 0)
    else:
        uidrank[np.argsort(uid_arr, kind="stable")] = np.arange(n)
        n_budget = n
        prio_budget = int(np.abs(prio_a).max(initial=0))
    uniq_ts = np.unique(res_ts_a[adm_a]) if adm_a.any() else np.empty(0)
    seq_a = np.zeros(n, dtype=np.int64)
    if len(uniq_ts):
        seq_a[adm_a] = np.searchsorted(uniq_ts, res_ts_a[adm_a]) + 1
    seq_base = int(len(uniq_ts)) + 2

    wl_rank[ci_a, mi_a] = mi_a
    wl_cycle_rank[ci_a, mi_a] = crank
    wl_prio[ci_a, mi_a] = np.clip(prio_a, -I32_MAX, I32_MAX)
    wl_uidrank[ci_a, mi_a] = uidrank
    parked[ci_a, mi_a] = parked_a
    elig[ci_a, mi_a] = ~parked_a & ~adm_a
    vec_ok[ci_a, mi_a] = ok_a
    resume[ci_a, mi_a] = resume_a
    wl_req[ci_a, mi_a] = req_all
    adm[ci_a, mi_a] = adm_a
    adm_seq[ci_a, mi_a] = seq_a
    adm_usage[ci_a, mi_a] = usage_all
    adm_uses[ci_a, mi_a] = uses_all
    key_list = key_arr.tolist()   # plain str (key_arr is unicode-dtype)
    keys_grid = np.empty((C, M), dtype=object)   # fills with None
    keys_grid[ci_a, mi_a] = np.array(key_list, dtype=object)
    keys: list[list] = keys_grid.tolist()
    row_of_key: dict = dict(zip(
        key_list, zip(ci_a.tolist(), mi_a.tolist())))

    # CQ-level usage, scaled exactly (else no burst) — per-record rows
    if (prev is not None and prev[1] is not None
            and "u_cq" in prev[1] and len(prev[0]) == len(records)):
        u_cq = prev[1]["u_cq"].copy()
        for i, r in enumerate(records):
            if r is not prev[0][i]:
                u_cq[i] = r.u_row
    else:
        u_cq = np.stack([r.u_row for r in records])
    if fields_out is not None:
        fields_out["u_cq"] = u_cq

    # preemption policy flags + the in-kernel modeling envelope
    forest_bad = s.deep.copy()
    for r in records:
        if r.bad:
            forest_bad[int(forest_of_cq[r.ci])] = True
    KC = min(KC_CAP, ((L * M + 31) // 32) * 32)
    if L * M > KC:
        forest_bad[:] = True
    if not ordering.priority_sorting_within_cohort:
        forest_bad[:] = True
    # the kernel's composite candidate-ordering keys pack priority and
    # reservation-seq into 20-bit fields and uid rank into 19; in-burst
    # admissions consume seq_base..seq_base+K-1, so the headroom is the
    # largest window the ladder can dispatch (not a hardcoded constant).
    # Only budget rows (rows the candidate keys can ever encode) are
    # charged against the 2^19/2^20 fields; the seq gate stays global
    # because reservation seqs are dense over distinct admitted
    # timestamps regardless of forest.
    if (prio_budget >= (1 << 20)
            or seq_base + max(K_BURST_LADDER) >= (1 << 20)
            or n_budget >= (1 << 19)):
        forest_bad[:] = True
    preempt_ok = s.modelable_base & ~forest_bad[forest_of_cq]
    # pure function of the structure statics + (M, KC); M is sticky
    # across re-packs, so boundaries after the first reuse the tables
    tables = s.cand_tables.get((M, KC))
    if tables is None:
        tables = build_candidate_tables(forest_of_cq, s.members, M, KC)
        s.cand_tables[(M, KC)] = tables
    cand_rows, cand_lmem, self_lmem = tables

    arrays = dict(
        wl_req=wl_req, wl_rank=wl_rank, wl_cycle_rank=wl_cycle_rank,
        wl_prio=wl_prio, wl_uidrank=wl_uidrank,
        vec_ok=vec_ok, elig0=elig, parked0=parked, resume0=resume,
        adm0=adm, adm_seq0=adm_seq, adm_usage0=adm_usage,
        adm_uses0=adm_uses, death0=death,
        u_cq0=u_cq, potential0=s.potential0,
        subtree=st.subtree_quota, guaranteed=st.guaranteed,
        borrow_cap=st.borrow_cap, has_blim=st.has_borrow_limit,
        parent=st.parent, node_level=node_level,
        nominal_cq=st.nominal_cq, npb_cq=st.nominal_plus_blimit_cq,
        slot_fr=st.slot_fr, slot_valid=st.slot_valid,
        cq_can_preempt_borrow=st.cq_can_preempt_borrow,
        cq_wcb_borrow=st.cq_wcb_borrow, cq_wcp_preempt=st.cq_wcp_preempt,
        forest_of_cq=forest_of_cq, strict_cq=strict,
        wcq_lower=s.wcq_lower, rwc_enabled=s.rwc_enabled,
        rwc_only_lower=s.rwc_only_lower, preempt_ok=preempt_ok,
        members=s.members, cand_rows=cand_rows, cand_lmem=cand_lmem,
        self_lmem=self_lmem)
    # max_res_ts feeds the driver's admission-clock monotonicity check,
    # so it must cover aggregate-compressed admitted rows too (their
    # reservation times are real; only their packed rows are elided)
    max_res_ts = float(res_ts_a[adm_a].max()) if adm_a.any() else None
    comp_max = max((r.comp_max_ts for r in records if r.n_comp),
                   default=None)
    if comp_max is not None:
        max_res_ts = (comp_max if max_res_ts is None
                      else max(max_res_ts, comp_max))
    return BurstPlan(structure=st, arrays=arrays, keys=keys,
                     C=C, M=M, L=L, G=G, n_levels=s.n_levels, KC=KC,
                     seq_base=seq_base, row_of_key=row_of_key,
                     max_res_ts=max_res_ts,
                     budget_rows=n_budget, grid_rows=n)


def pack_burst(structure, queues, cache, scheduler, clock,
               min_m: int = 0, window: int = 0) -> Optional[BurstPlan]:
    """Build the dense [C, M] state from the live queues + cache.

    Rows cover BOTH pending workloads (heap + parking lot) and admitted
    workloads (the quota-holding table preemption selects targets from).
    Returns None when the cluster can't be burst-scheduled at all
    (inexact usage scaling, unknown flavor-resources).  Per-workload
    limitations never fail the pack — they mark the row ``vec_ok=False``
    (pending) or gate the forest out of the in-kernel preemption
    envelope (admitted), so the affected cycles go dirty and run on the
    normal host path instead.

    ``window`` > 0 bounds the dispatch's cycle count: only the
    ``window + 2`` best-ranked pending rows per CQ are packed (plus all
    admitted rows).  Sound because at most one row per CQ leaves the
    eligible set per cycle, so a row below the cutoff cannot become a
    head within the window; any modeling miss is caught by the driver's
    per-cycle heads validation (truncate + repack)."""
    st = structure
    if _unknown_active_cq(st, queues):
        return None   # an active CQ the structure doesn't know
    records = _walk_records(st, queues, cache, scheduler, window)
    if records is None:
        return None
    return _assemble_plan(st, records, cache, scheduler, min_m)


class DeltaPackState:
    """Persistent per-CQ row records carried across burst windows.

    Valid for one (structure generation, resource scale, CQ set,
    window) key; ``pack_burst_cached`` re-walks only journaled-dirty
    CQs against it and re-fuses stage B from the mixed records.
    ``fields`` holds the flat stage-B row concatenation so the next
    window splices only the dirty segments.  ``token`` is a process-wide
    monotone serial: plans record the tokens they consumed/produced so a
    shard-resident device copy can prove it chains from the same state
    (object identity is not enough — ids alias after GC)."""
    __slots__ = ("key", "records", "fields", "token")

    _next_token = itertools.count(1)

    def __init__(self, key, records, fields=None):
        self.key = key
        self.records = records
        self.fields = fields
        self.token = next(DeltaPackState._next_token)


def _roundtrips_clean(rec, q, cq_live, keys, covers_pods) -> bool:
    """Verify that popped-and-requeued heads still match their packed
    rows: same Info object, same parked bit, same flavor-walk start
    slot.  These are the only row facts a pop/requeue roundtrip can
    move without hitting a hard journal touch."""
    from .solver import resume_start
    if q is None or not q.active or cq_live is None:
        return False
    for key in keys:
        parked_now = False
        info = q.heap.get(key)
        if info is None:
            info = q.inadmissible.get(key)
            if info is None:
                return False
            rs = info.obj.requeue_state
            if rs is not None and rs.requeue_at is not None:
                return False   # now backoff-parked: membership changed
            parked_now = True
        idx = rec.index_of_key.get(key)
        if idx is None:
            # below the window cutoff is the only legitimate absence
            if not rec.truncated:
                return False
            continue
        if rec.infos[idx] is not info or idx >= rec.n_pend:
            return False
        if bool(rec.parked[idx]) != parked_now:
            return False
        if int(rec.resume[idx]) != resume_start(info, cq_live,
                                                covers_pods):
            return False
    return True


# above this dirty share a delta walk rebuilds nearly everything anyway
# and the journal bookkeeping makes it slower than a plain full pack
_DELTA_MAX_DIRTY_FRAC = 0.5
_DELTA_MIN_DIRTY_CQS = 8


def pack_burst_cached(structure, queues, cache, scheduler, clock,
                      state=None, min_m: int = 0, window: int = 0,
                      stats=None):
    """Delta-maintained pack_burst; returns ``(plan, state, was_delta)``.

    Routing front door: by default the *streaming* delta pack
    (ops/stream_pack.py) serves the boundary — it patches a persistent
    packed-universe arena in place, O(arrivals + dirty) per window
    instead of the classic path's O(total rows) stage-B reassembly.
    ``KUEUE_TPU_STREAM_PACK=0`` opts back into the classic delta pack,
    ``KUEUE_BURST_DELTA_PACK=0`` forces a full walk every window
    (either path), and a structure the streaming encoder cannot model
    (non-ASCII or oversized workload keys) self-poisons back to the
    classic path.  Both paths share the return contract and produce
    bit-identical plans (test-enforced)."""
    import os
    if (env_value("KUEUE_TPU_STREAM_PACK") != "0"
            and os.environ.get("KUEUE_BURST_DELTA_PACK", "1") != "0"
            and not getattr(structure, "_stream_poison", False)):
        from .stream_pack import pack_burst_streaming
        return pack_burst_streaming(structure, queues, cache, scheduler,
                                    clock, state=state, min_m=min_m,
                                    window=window, stats=stats)
    return _pack_burst_cached_classic(structure, queues, cache,
                                      scheduler, clock, state=state,
                                      min_m=min_m, window=window,
                                      stats=stats)


def _pack_burst_cached_classic(structure, queues, cache, scheduler,
                               clock, state=None, min_m: int = 0,
                               window: int = 0, stats=None):
    """The classic delta pack: re-walk journaled-dirty CQs, re-fuse
    stage B from the mixed records.

    Drains the queue-manager and cache PackJournals; when ``state``
    covers the same (structure generation, resource scale, CQ set,
    window) key and nothing forced a full walk, only journaled-dirty
    CQs are re-walked and the surviving records re-fuse through stage B
    — the boundary pays O(dirty rows) of Python walk instead of O(all
    rows).  Any miss (key change, dirty-all, roundtrip drift, CQ the
    delta path can't model) falls back to a full walk, counted in
    ``stats``.  The returned plan is bit-identical to ``pack_burst`` of
    the same live state (test-enforced by tests/test_delta_pack.py);
    ``KUEUE_BURST_DELTA_PACK=0`` forces the full walk every window."""
    import os
    import time
    st = structure
    dirty: set = set()
    soft: dict = {}
    jranges: list = []
    force_full = False
    for j in (getattr(queues, "pack_journal", None),
              getattr(cache, "pack_journal", None)):
        if j is None:
            force_full = True
        else:
            force_full |= j.drain_into(dirty, soft, row_of=st.cq_index,
                                       ranges_out=jranges)
    enabled = os.environ.get("KUEUE_BURST_DELTA_PACK", "1") != "0"
    from .aggregate import agg_planes_enabled
    key = (st.generation, st.resource_scale.tobytes(),
           tuple(st.cq_names), window, agg_planes_enabled())

    def _full():
        if _unknown_active_cq(st, queues):
            return None, None, False
        records = _walk_records(st, queues, cache, scheduler, window)
        if records is None:
            return None, None, False
        fields: dict = {}
        plan = _assemble_plan(st, records, cache, scheduler, min_m,
                              fields_out=fields if enabled else None)
        if plan is None:
            return None, None, False
        if stats is not None:
            stats["burst_full_packs"] = (
                stats.get("burst_full_packs", 0) + 1)
            stats["rows_repacked"] = (
                stats.get("rows_repacked", 0)
                + sum(r.n_rows for r in records))
        new_state = (DeltaPackState(key, records, fields) if enabled
                     else None)
        # a full walk cannot chain a resident device copy (dirty set is
        # unbounded) but it SEEDS one: the next delta pack may scatter
        plan.pack_token = new_state.token if new_state else None
        return plan, new_state, False

    if not enabled or state is None or state.key != key or force_full:
        return _full()

    t0 = time.perf_counter()
    index_of = st.cq_index
    C = len(st.cq_names)
    # a dirty CQ the structure doesn't know fails the pack exactly when
    # the full walk would (active with pending work); clean unknown CQs
    # were checked at state creation and only change through journaled
    # mutators
    for name in dirty | set(soft):
        if name not in index_of:
            q = queues.queue_for(name)
            if q is not None and q.active and q.pending_active():
                return None, None, False
    # soft-dirty roundtrips: verify the packed dynamic bits still hold;
    # escalate the CQ to a re-walk when they moved
    for name, skeys in soft.items():
        ci = index_of.get(name)
        if ci is None or name in dirty:
            continue
        if not _roundtrips_clean(state.records[ci],
                                 queues.queue_for(name),
                                 cache.cluster_queue(name), skeys,
                                 name in structure.cq_covers_pods):
            dirty.add(name)

    # at full churn the per-CQ delta walk is a near-complete rebuild
    # plus journal/roundtrip overhead — measurably slower than the
    # straight full walk at north-star scale.  The floor keeps small
    # packs on the delta path so its machinery stays exercised.
    if len(dirty) > max(_DELTA_MIN_DIRTY_CQS, _DELTA_MAX_DIRTY_FRAC * C):
        return _full()

    records = list(state.records)
    pos_of = {name: i for i, name in
              enumerate(queues.cluster_queue_names())}
    assumed = cache.assumed_workloads
    scale_of = {r: int(st.resource_scale[i])
                for i, r in enumerate(st.resource_names)}
    repacked = 0
    for name in dirty:
        ci = index_of.get(name)
        if ci is None:
            continue
        rec = _pack_cq_rows(st, ci, pos_of.get(name, C), queues, cache,
                            scheduler, assumed, scale_of, window)
        if rec is _PACK_FAIL:
            return None, None, False
        records[ci] = rec
        repacked += rec.n_rows
    # heads-enumeration positions can shift when CQs leave the queue
    # manager; refresh them on every record (clean ones included)
    for rec in records:
        rec.pos = pos_of.get(st.cq_names[rec.ci], C)
    fields: dict = {}
    plan = _assemble_plan(st, records, cache, scheduler, min_m,
                          prev=(state.records, state.fields),
                          fields_out=fields)
    if plan is None:
        return None, None, False
    new_state = DeltaPackState(key, records, fields)
    # resident chaining facts: which state this plan consumed/produced
    # and exactly which CQ rows differ from the consumed state's plan
    # (post-escalation; clean rows were spliced verbatim, so a device
    # copy of the previous rows needs only these scattered)
    dirty_cis = sorted(index_of[name] for name in dirty
                       if name in index_of)
    plan.pack_token = new_state.token
    plan.prev_token = state.token
    plan.dirty_cqs = np.asarray(dirty_cis, dtype=np.int64)
    from ..utils.journal import PackJournal
    plan.dirty_ranges = PackJournal.coalesce(dirty_cis)
    if stats is not None:
        stats["burst_delta_packs"] = (
            stats.get("burst_delta_packs", 0) + 1)
        stats["rows_repacked"] = (
            stats.get("rows_repacked", 0) + repacked)
        stats["rows_reused"] = (
            stats.get("rows_reused", 0)
            + sum(r.n_rows for r in records) - repacked)
        stats["delta_pack_s"] = (
            stats.get("delta_pack_s", 0.0) + time.perf_counter() - t0)
        stats["burst_journal_dirty_ranges"] = (
            stats.get("burst_journal_dirty_ranges", 0) + len(jranges))
    return plan, new_state, True


# one K rung: every distinct K is a full kernel compilation, and a
# 32-cycle window amortizes the dispatch while deciding a few unused
# cycles at most ~15ms of kernel time when fewer remain
K_BURST_LADDER = (32,)


class _ResidentRows:
    """Shard-resident scatter-tier row planes from the last fresh
    sharded dispatch, keyed by the DeltaPackState token that produced
    them.  The next fresh pack reuses them when its ``prev_token``
    matches: the delta pack spliced every clean record verbatim, so
    only its ``dirty_cqs`` rows need to re-cross the host boundary.
    The dirty rows are written into these planes in place, so the plan
    that owned them (``owner``, weakly held) loses its cached launch
    inputs when they move on (``hand_over``)."""
    __slots__ = ("layout", "token", "planes", "owner")

    def __init__(self, layout, token, planes, owner):
        self.layout = layout
        self.token = token
        self.planes = planes
        self.owner = weakref.ref(owner)

    def hand_over(self) -> dict:
        """The planes, for a scatter that overwrites them in place: the
        previous owner plan re-gathers from host if it launches again
        instead of reading the next plan's rows."""
        owner = self.owner()
        if owner is not None:
            owner._resident_args = None
        return dict(self.planes)


@dataclass
class BurstHandle:
    """An in-flight fused-burst launch.

    The kernel has been launched (asynchronously on "cuda"; the plain
    version has already run on "cpu"); ``BurstSolver.fetch`` blocks for
    the decisions.  ``carry`` keeps the final scan state as tensors on
    the solver's device after fetch, so ``dispatch_next`` can chain the
    following window off it without a host re-pack."""
    plan: BurstPlan
    K: int
    runtime: int
    seq_base: int                # absolute seq base of THIS window
    dev: object
    pending: object = None       # kernel output tuple, still async
    decisions: tuple = None      # fetched numpy decision arrays
    flags: tuple = None          # (dirty, dirty_reason) via fetch_flags
    carry: tuple = None          # final scan state (tensors)
    speculative: bool = False
    t_dispatch: float = 0.0
    sharded: bool = False        # launched on the burst mesh
    layout: object = None        # BurstShardLayout of a sharded launch


class BurstSolver:
    """Launch fused bursts and expose the decisions for application.

    ``device``: "cuda" (default) launches ``kernels/burst_cycles.cu`` and
    raises without a GPU; "cpu" runs ``burst_cycles_plain``.  There is
    no route from one to the other.  ``set_shards(n)`` partitions the
    cohort forests over a burst mesh of n devices
    (``parallel.sharded``): one launch per shard, each on its own device
    and stream, and the dirty flags reduced on shard 0."""

    def __init__(self, device="cuda"):
        from .solver import resolve_device
        self.device = resolve_device(device)
        self.stats = {"burst_dispatches": 0, "burst_cycles_decided": 0,
                      "burst_cuda_dispatches": 0,
                      "burst_dispatch_s": 0.0,
                      # boundary + fallback visibility
                      "burst_pack_s": 0.0, "burst_packs": 0,
                      "burst_suppressed_cycles": 0,
                      "burst_dirty_cycles": 0,
                      "burst_dirty_preempt": 0,
                      "burst_dirty_scalar": 0,
                      "burst_dirty_resume": 0,
                      # cycles decided inside bursts by kind
                      "burst_preempt_cycles": 0,
                      # pipelined boundary (speculative next-window
                      # dispatches chained off the kernel's final carry)
                      "burst_spec_dispatches": 0,
                      "burst_overlapped_packs": 0,
                      "burst_spec_cancelled": 0,
                      "burst_serial_windows": 0,
                      "burst_spec_fetch_wait_s": 0.0,
                      # modeled preempt target vanished before apply
                      "burst_target_divergences": 0,
                      # incremental delta-pack boundary (persistent
                      # per-CQ row records; full repack on any miss)
                      "burst_delta_packs": 0, "burst_full_packs": 0,
                      "rows_reused": 0, "rows_repacked": 0,
                      "delta_pack_s": 0.0,
                      # graceful degradation (chaos shard.device_loss or
                      # lose_devices): mesh rebuilt over the survivors,
                      # serial fallback when fewer than two remain
                      "burst_shard_degradations": 0,
                      "burst_shard_serial_fallbacks": 0,
                      # speculative windows discarded by injected faults
                      "burst_chaos_divergences": 0,
                      # shard-resident boundary: fresh packs whose row
                      # planes stayed on the mesh (only dirty rows
                      # scattered from host) vs full re-uploads, and the
                      # host→device bytes actually paid vs what the
                      # upload-everything boundary would have paid
                      "burst_resident_hits": 0,
                      "burst_resident_misses": 0,
                      "burst_resident_scatter_rows": 0,
                      "burst_resident_scatter_ranges": 0,
                      "burst_resident_scatter_s": 0.0,
                      "burst_boundary_bytes_h2d": 0,
                      "burst_boundary_bytes_equiv": 0,
                      # coalesced dirty-row ranges seen by the journal
                      "burst_journal_dirty_ranges": 0,
                      # cost-balanced forest partition (EWMA of decided
                      # heads per forest, fed to BurstShardLayout)
                      "burst_layout_rebuilds": 0,
                      "burst_layout_cost_balanced": 0,
                      "burst_shard_cost_ratio": 0.0}
        # mesh-sharded dispatch (forest partition over a 1-D "cq" axis;
        # parallel.sharded.BurstShardLayout) — off until set_shards(n>1)
        self.n_shards = 1
        self._shard_mesh = None
        self._shard_layouts: dict = {}
        # shard-resident device copy of the last fresh pack's row planes
        # + the per-forest cycle-cost EWMA feeding the next layout
        self._resident = None
        self._forest_cost: dict | None = None
        # dtype tightening of the launch's packed planes (sticky
        # per-plane widths; KUEUE_TPU_PACK_TIGHTEN=0 disables)
        from .packing import TightenState
        self._tighten = TightenState()

    def set_shards(self, n: int):
        """Shard burst dispatches across ``n`` devices: cohort forests
        are partitioned over a 1-D ``("cq",)`` mesh, each shard's block
        runs the burst kernel on its device, and the dirty flags are
        reduced across shards.  ``n <= 1`` (or too few devices for a
        mesh) keeps the serial single-device path — graceful
        degradation, not an error."""
        from ..parallel.sharded import make_burst_mesh
        n = int(n or 0)
        mesh = make_burst_mesh(n, self.device) if n > 1 else None
        self.n_shards = mesh.size if mesh is not None else 1
        self._shard_mesh = mesh
        self._shard_layouts = {}
        self._resident = None
        if mesh is not None:
            self.stats.setdefault("burst_sharded_dispatches", 0)
            # per-shard timing vectors (list-valued stats): how long the
            # host spent building each shard's block of the permuted
            # inputs, and how long each shard's decision slice took to
            # become ready at fetch
            self.stats["burst_shard_pack_s"] = [0.0] * self.n_shards
            self.stats["burst_shard_fetch_s"] = [0.0] * self.n_shards

    def lose_devices(self, n_lost: int = 1) -> int:
        """Graceful shard degradation: ``n_lost`` devices of the burst
        mesh died.  The mesh is rebuilt over the survivors and the next
        ``_layout_for`` re-partitions the cohort forests across them
        (value-remapped exactly like the original layout, so decisions
        stay bit-identical); with fewer than two survivors the window
        re-runs on the serial single-device path.  Returns the new
        shard count."""
        if self.n_shards <= 1:
            return self.n_shards
        from ..parallel.sharded import make_burst_mesh
        survivors = max(1, self.n_shards - max(1, int(n_lost)))
        mesh = (make_burst_mesh(survivors, self.device) if survivors > 1
                else None)
        self.n_shards = mesh.size if mesh is not None else 1
        self._shard_mesh = mesh
        self._shard_layouts = {}
        # the resident copy is laid out for the dead mesh; the next
        # fresh pack re-gathers from host over the survivors
        self._resident = None
        self.stats["burst_shard_degradations"] += 1
        if mesh is None:
            self.stats["burst_shard_serial_fallbacks"] += 1
        else:
            self.stats["burst_shard_pack_s"] = [0.0] * self.n_shards
            self.stats["burst_shard_fetch_s"] = [0.0] * self.n_shards
        return self.n_shards

    @staticmethod
    def _layout_key(plan: BurstPlan):
        st = plan.structure
        return (id(st), st.generation, plan.C, plan.M, plan.G, plan.L,
                plan.KC)

    def _layout_for(self, plan: BurstPlan):
        from ..parallel.sharded import BurstShardLayout
        key = self._layout_key(plan)
        lay = self._shard_layouts.get(key)
        if lay is None:
            # feed the measured per-forest cycle cost when it was
            # sampled under this structure generation — layout rebuilds
            # happen only on structure/mesh change (or an explicit
            # refresh_layouts), so this is where rebalancing lands
            fc = self._forest_cost
            cost = None
            if (fc is not None
                    and fc["generation"] == plan.structure.generation
                    and fc["windows"] > 0 and len(fc["ewma"]) == plan.G):
                cost = fc["ewma"]
            t0 = time.perf_counter()
            lay = BurstShardLayout(plan, self.n_shards, forest_cost=cost)
            if os.environ.get("KUEUE_BURST_DEBUG"):
                print(f"layout rebuild: gen={plan.structure.generation} "
                      f"Cs={lay.Cs} Gs={lay.Gs} cost={cost is not None} "
                      f"{(time.perf_counter() - t0)*1e3:.1f}ms",
                      file=sys.stderr)
            self._shard_layouts = {key: lay}   # one structure at a time
            self.stats["burst_layout_rebuilds"] = (
                self.stats.get("burst_layout_rebuilds", 0) + 1)
            if lay.cost_balanced:
                self.stats["burst_layout_cost_balanced"] = (
                    self.stats.get("burst_layout_cost_balanced", 0) + 1)
            self.stats["burst_shard_cost_ratio"] = lay.cost_ratio
            self.stats["burst_shard_cost"] = list(lay.shard_cost)
        return lay

    def refresh_layouts(self):
        """Drop cached shard layouts so the NEXT fresh pack re-partitions
        the forests with the current cycle-cost EWMA.  Callers must hold
        no in-flight handles (the driver's window boundary, a harness's
        warmup/measure seam): a chained carry is laid out for the old
        partition and dispatch_next refuses to cross layouts."""
        self._shard_layouts = {}
        self._resident = None

    def _note_forest_activity(self, plan: BurstPlan, head_row):
        """Fold one fetched window's decided heads into the per-forest
        cycle-cost EWMA (keyed by structure generation)."""
        hr = np.asarray(head_row)
        if hr.ndim != 2:
            return
        cols = np.nonzero(hr >= 0)[1]
        sample = np.bincount(
            np.asarray(plan.arrays["forest_of_cq"])[cols],
            minlength=plan.G).astype(np.float64)
        fc = self._forest_cost
        gen = plan.structure.generation
        if (fc is None or fc["generation"] != gen
                or len(fc["ewma"]) != plan.G):
            self._forest_cost = {"generation": gen, "ewma": sample,
                                 "windows": 1}
        else:
            fc["ewma"] = 0.7 * fc["ewma"] + 0.3 * sample
            fc["windows"] += 1

    def _plan_tensors(self, plan: BurstPlan) -> dict:
        """The plan's static planes on the solver's device, uploaded once
        per plan (a chained window reuses them), narrowed at the transfer
        boundary by ``tighten_arrays``; on "cuda" also the kernel's
        per-forest node table."""
        cached = getattr(plan, "_torch_planes", None)
        if cached is not None and cached[0] == self.device:
            return cached[1]
        from .packing import plan_to_torch
        a = {k: v for k, v in plan.arrays.items() if k not in STATE_NAMES}
        if env_value("KUEUE_TPU_PACK_TIGHTEN") != "0":
            # narrow the rank/index/request planes at the transfer
            # boundary only — plan.arrays keeps the reference int32
            # dtypes; the kernel reads any integer width
            from .packing import tighten_arrays
            a = tighten_arrays(a, self._tighten, self.stats)
        self.stats["burst_launch_bytes_h2d"] = (
            self.stats.get("burst_launch_bytes_h2d", 0)
            + sum(v.nbytes for v in a.values()))
        planes = plan_to_torch(a, self.device)
        if self.device.type == "cuda":
            from .. import kernels
            planes["_node_table"] = kernels.burst_node_table(
                plan.arrays["parent"], plan.arrays["node_level"],
                plan.arrays["forest_of_cq"], plan.G, self.device)
        plan._torch_planes = (self.device, planes)
        return planes

    def _launch(self, plan: BurstPlan, K: int, runtime: int,
                ext_release, ext_unpark, state, seq_base: int,
                speculative: bool, permuted: bool = False) -> BurstHandle:
        """Issue one fused launch without waiting for its results.
        ``state`` is the 9-tuple of *0 scan-state planes (numpy for a
        packed window, device tensors for a chained one); ``permuted``
        marks a chained state already in shard layout."""
        if (_chaos.ACTIVE is not None and self.n_shards > 1
                and not speculative and not permuted):
            # device loss lands at fresh packs only: a chained carry is
            # laid out for the old mesh and dispatch_next already
            # refuses to cross dispatch modes
            f = _chaos.ACTIVE.hit("shard.device_loss")
            if f is not None:
                self.lose_devices(int(f.payload or 1))
        if self.n_shards > 1 and self._shard_mesh is not None:
            return self._launch_sharded(plan, K, runtime, ext_release,
                                        ext_unpark, state, seq_base,
                                        speculative, permuted)
        st = plan.structure
        dev = self.device
        a = self._plan_tensors(plan)
        state = tuple(
            s if isinstance(s, torch.Tensor)
            else torch.from_numpy(np.ascontiguousarray(s)).to(dev)
            for s in state)
        self.stats["burst_launch_bytes_h2d"] = (
            self.stats.get("burst_launch_bytes_h2d", 0)
            + sum(s.nbytes for s in state if isinstance(s, np.ndarray))
            + ext_release.nbytes + ext_unpark.nbytes)
        ext = (torch.from_numpy(np.ascontiguousarray(ext_release)).to(dev),
               torch.from_numpy(np.ascontiguousarray(ext_unpark)).to(dev))
        vals = dict(zip(STATE_NAMES, state))
        vals["seq_base"] = int(seq_base)
        vals["ext_release"], vals["ext_unpark"] = ext
        args = [vals[n] if n in vals else a[n] for n in ARG_NAMES]
        kw = dict(K=K, depth=st.depth, L=plan.L,
                  S=int(st.slot_fr.shape[1]), KC=plan.KC,
                  n_levels=plan.n_levels, G=plan.G, runtime=max(0, runtime))
        if dev.type == "cuda":
            kw["node_table"] = a["_node_table"]
        t0 = time.perf_counter()
        out = burst_cycles(*args, **kw)
        self.stats["burst_dispatches"] += 1
        self.stats["burst_cycles_decided"] += K
        if speculative:
            self.stats["burst_spec_dispatches"] += 1
        else:
            self.stats["burst_serial_windows"] += 1
        if dev.type == "cuda":
            self.stats["burst_cuda_dispatches"] += 1
        return BurstHandle(plan=plan, K=K, runtime=runtime,
                           seq_base=seq_base, dev=dev, pending=out,
                           speculative=speculative, t_dispatch=t0)

    def _static_inputs(self, plan: BurstPlan, layout, timers) -> dict:
        """The STATIC tier on the mesh, uploaded once per layout (with
        each shard's node table for the CUDA kernel)."""
        dev_static = layout._static_dev
        if dev_static is None:
            from ..parallel.sharded import shard_node_tables
            mesh = self._shard_mesh
            t_s = time.perf_counter()
            host = layout.static_arrays(plan, timers)
            dev_static = {k: mesh.put(v) for k, v in host.items()}
            dev_static["_node_tables"] = shard_node_tables(mesh, layout)
            layout._static_dev = dev_static
            layout._static_nbytes = sum(v.nbytes for v in host.values())
            self.stats["burst_boundary_bytes_h2d"] += layout._static_nbytes
            if os.environ.get("KUEUE_BURST_DEBUG"):
                print(f"static tier upload: "
                      f"{layout._static_nbytes/1e6:.1f}MB "
                      f"{(time.perf_counter() - t_s)*1e3:.1f}ms",
                      file=sys.stderr)
        return dev_static

    def _scatter_resident(self, layout, planes: dict, rows: np.ndarray,
                          vals: list) -> None:
        """Write the padded dirty rows (global shard-layout positions,
        ``rows``) and their values into the resident planes, in place:
        each row goes to its shard, one ``scatter_rows`` launch per
        shard that has rows (all 13 planes at once)."""
        from ..parallel import sharded
        mesh = self._shard_mesh
        Cs = layout.Cs
        shard = rows // Cs
        for s in np.unique(shard):
            s = int(s)
            sel = shard == s
            with mesh.on(s):
                dev = mesh.devices[s]
                rows_s = torch.from_numpy(
                    (rows[sel] - s * Cs).astype(np.int32)).to(dev)
                vals_s = [torch.from_numpy(np.ascontiguousarray(v[sel]))
                          .to(dev) for v in vals]
                sharded.scatter_rows(
                    [planes[n][s] for n in sharded.SCATTER_PLANES],
                    rows_s, vals_s)

    def _resident_inputs(self, plan: BurstPlan, layout, timers) -> dict:
        """Sharded kernel inputs for a FRESH pack under the
        shard-resident boundary (``KUEUE_TPU_RESIDENT``, default on):

        - STATIC tier: permuted + uploaded once per layout lifetime;
        - SCATTER tier (row records + scan-state init planes): reused
          on the mesh when this plan chains the resident copy's pack
          token — only ``plan.dirty_cqs`` rows are scattered from host,
          coalesced (journal.PackJournal.coalesce) and bucketed
          (packing.scatter_pad), one ``scatter_rows`` launch per shard
          for all planes;
        - GLOBAL tier (dense cross-CQ ranks, preempt envelope):
          re-uploaded every fresh pack.

        ``KUEUE_TPU_RESIDENT_VERIFY=1`` asserts every scattered plane is
        bit-identical to a full host permute (test harness switch).
        Returns the merged name → per-shard tensors dict."""
        from ..parallel.sharded import (
            _C_FILLS, SCATTER_PLANES, GLOBAL_PLANES)
        from ..utils.journal import PackJournal
        from .packing import scatter_pad
        a = plan.arrays
        mesh = self._shard_mesh
        stats = self.stats
        dev_static = self._static_inputs(plan, layout, timers)
        stats["burst_boundary_bytes_equiv"] += layout._static_nbytes

        res = self._resident
        hit = (res is not None and res.layout is layout
               and plan.prev_token is not None
               and res.token == plan.prev_token
               and plan.dirty_cqs is not None)
        SCs = layout.n_shards * layout.Cs
        full_bytes = sum((a[n].nbytes // max(1, plan.C)) * SCs
                        for n in SCATTER_PLANES)
        t0 = time.perf_counter()
        if hit:
            planes = res.hand_over()
            dirty = np.asarray(plan.dirty_cqs)
            D = int(dirty.size)
            if D:
                pos = layout.cq_pos[dirty]
                order = np.argsort(pos, kind="stable")
                cis = dirty[order]
                rows = pos[order].astype(np.int32)
                ranges = PackJournal.coalesce(rows.tolist())
                Dp = scatter_pad(D)
                rows_pad = (np.concatenate(
                    [rows, np.repeat(rows[-1:], Dp - D)])
                    if Dp != D else rows)
                nb = 0
                vals_all = []
                for name in SCATTER_PLANES:
                    vals = np.ascontiguousarray(a[name][cis])
                    nb += vals.nbytes
                    if Dp != D:
                        vals = np.concatenate(
                            [vals, np.repeat(vals[-1:], Dp - D, axis=0)])
                    vals_all.append(vals)
                self._scatter_resident(layout, planes, rows_pad, vals_all)
                stats["burst_resident_scatter_rows"] += D
                stats["burst_resident_scatter_ranges"] += len(ranges)
                stats["burst_boundary_bytes_h2d"] += nb
            stats["burst_resident_hits"] += 1
            stats["burst_resident_scatter_s"] += time.perf_counter() - t0
            if env_value("KUEUE_TPU_RESIDENT_VERIFY"):
                for name in SCATTER_PLANES:
                    want = layout.permute_rows(a[name], _C_FILLS[name])
                    if not np.array_equal(mesh.gather(planes[name]), want):
                        raise AssertionError(
                            f"resident scatter drift in {name}")
        else:
            planes = {
                name: mesh.put(layout.permute_rows(
                    a[name], _C_FILLS[name], timers), timers)
                for name in SCATTER_PLANES}
            stats["burst_resident_misses"] += 1
            stats["burst_boundary_bytes_h2d"] += full_bytes
            if os.environ.get("KUEUE_BURST_DEBUG"):
                print(f"resident miss: {full_bytes/1e6:.1f}MB "
                      f"{(time.perf_counter() - t0)*1e3:.1f}ms",
                      file=sys.stderr)
        stats["burst_boundary_bytes_equiv"] += full_bytes

        glob = {}
        for name in GLOBAL_PLANES:
            host = layout.permute_rows(a[name], _C_FILLS[name], timers)
            glob[name] = mesh.put(host, timers)
            stats["burst_boundary_bytes_h2d"] += host.nbytes
            stats["burst_boundary_bytes_equiv"] += host.nbytes
        self._resident = (
            _ResidentRows(layout, plan.pack_token, planes, plan)
            if plan.pack_token is not None else None)
        merged = dict(dev_static)
        merged.update(planes)
        merged.update(glob)
        return merged

    def _shard_inputs(self, plan: BurstPlan, layout, timers) -> dict:
        """The permuted plan on the mesh without the resident boundary
        (``KUEUE_TPU_RESIDENT=0``): every non-state plane uploaded once
        per plan, chained windows reuse it."""
        cached = getattr(plan, "_shard_tensors", None)
        if cached is not None and cached[0] is layout:
            return cached[1]
        host = layout.plan_arrays(plan, timers)
        out = dict(self._static_inputs(plan, layout, timers))
        for k, v in host.items():
            if k not in out:
                out[k] = self._shard_mesh.put(v, timers)
        plan._shard_tensors = (layout, out)
        return out

    def _launch_sharded(self, plan: BurstPlan, K: int, runtime: int,
                        ext_release, ext_unpark, state, seq_base: int,
                        speculative: bool, permuted: bool) -> BurstHandle:
        """Mesh-sharded twin of the serial launch: plan tensors and scan
        state are permuted into per-forest shard blocks (value-remapped
        so every rank/slot the kernel compares is carried verbatim —
        decisions stay bit-identical) and each shard's block is launched
        on its device (``parallel.sharded.sharded_burst``).  With the
        resident boundary on, the permuted row planes live on the mesh:
        a fresh pack scatters only its dirty rows (``_resident_inputs``)
        and a chained window reuses the cached device dict outright."""
        from ..parallel.sharded import _STATE_NAMES, sharded_burst
        layout = self._layout_for(plan)
        mesh = self._shard_mesh
        timers = self.stats.get("burst_shard_pack_s")
        a = None
        if env_value("KUEUE_TPU_RESIDENT") != "0":
            cached = getattr(plan, "_resident_args", None)
            if cached is not None and cached[0] is layout:
                a = cached[1]
            elif not permuted:
                a = self._resident_inputs(plan, layout, timers)
                plan._resident_args = (layout, a)
            if a is not None and not permuted:
                state = tuple(a[n] for n in _STATE_NAMES)
        if a is None:
            a = self._shard_inputs(plan, layout, timers)
            if not permuted:
                state = tuple(mesh.put(x, timers)
                              for x in layout.permute_state(state, timers))
        extr, extu = layout.permute_ext(ext_release, ext_unpark)
        ext = (mesh.put_ax1(extr), mesh.put_ax1(extu))
        st = plan.structure
        t0 = time.perf_counter()
        out = sharded_burst(
            mesh, a, state, seq_base, ext, K=K, depth=st.depth, L=plan.L,
            S=int(st.slot_fr.shape[1]), KC=plan.KC,
            n_levels=plan.n_levels, G=layout.Gs, runtime=max(0, runtime),
            node_tables=a["_node_tables"])
        self.stats["burst_dispatches"] += 1
        self.stats["burst_cycles_decided"] += K
        self.stats["burst_sharded_dispatches"] = (
            self.stats.get("burst_sharded_dispatches", 0) + 1)
        if speculative:
            self.stats["burst_spec_dispatches"] += 1
        else:
            self.stats["burst_serial_windows"] += 1
        dev = mesh.devices[0]
        if dev.type == "cuda":
            self.stats["burst_cuda_dispatches"] += 1
        return BurstHandle(plan=plan, K=K, runtime=runtime,
                           seq_base=seq_base, dev=dev, pending=out,
                           speculative=speculative, t_dispatch=t0,
                           sharded=True, layout=layout)

    def dispatch(self, plan: BurstPlan, K: int, runtime: int,
                 ext_release: np.ndarray,
                 ext_unpark: np.ndarray) -> BurstHandle:
        """Async launch of a freshly packed window."""
        a = plan.arrays
        state = tuple(a[n] for n in STATE_NAMES)
        return self._launch(plan, K, runtime, ext_release, ext_unpark,
                            state, plan.seq_base, speculative=False)

    def dispatch_next(self, handle: BurstHandle, ext_release: np.ndarray,
                      ext_unpark: np.ndarray) -> BurstHandle | None:
        """Speculatively chain the NEXT window off a fetched handle's
        final carry: the plan's static tensors are reused, the scan
        state stays on the device, ``death`` is rebased by -K and
        ``seq_base`` advances by K.  Returns None when the composite-key
        seq field would overflow (the serial path re-packs and its gate
        decides).  The caller owns validity: any apply-side divergence
        from the modeled window must discard the handle unfetched."""
        if handle.carry is None:
            return None
        # a carry from one dispatch mode can't chain into the other
        # (sharded carries live in shard layout): force a re-pack
        if handle.sharded != (self.n_shards > 1
                              and self._shard_mesh is not None):
            return None
        # nor across layouts: after lose_devices/refresh_layouts the
        # next _layout_for would re-partition and the carry's shard
        # blocks no longer line up with the new permutation
        if (handle.sharded and handle.layout is not None
                and self._shard_layouts.get(
                    self._layout_key(handle.plan)) is not handle.layout):
            return None
        seq_base = handle.seq_base + handle.K
        # same headroom discipline as pack_burst's overflow gate
        if seq_base + max(K_BURST_LADDER) >= (1 << 20):
            return None

        def rebase(adm, death):
            return torch.where(adm & (death != INF_I32),
                               death - handle.K, INF_I32).to(torch.int32)

        carry = list(handle.carry)
        if handle.sharded:
            # per shard, on its own stream, where its carry lives
            mesh = self._shard_mesh
            deaths = []
            for s in range(mesh.size):
                with mesh.on(s):
                    deaths.append(rebase(carry[3][s], carry[7][s]))
            carry[7] = tuple(deaths)
        else:
            carry[7] = rebase(carry[3], carry[7])
        return self._launch(handle.plan, handle.K, handle.runtime,
                            ext_release, ext_unpark, tuple(carry),
                            seq_base, speculative=True,
                            permuted=handle.sharded)

    def fetch_flags(self, handle: BurstHandle):
        """Flags-first half of the fetch: wait only for the tiny
        (dirty, dirty_reason) planes — the speculation gate's whole
        input — and park the final carry for ``dispatch_next``, so the
        caller can chain the next window before the full ``fetch``."""
        if handle.decisions is not None:
            return handle.decisions[5], handle.decisions[6]
        if handle.flags is not None:
            return handle.flags
        out = handle.pending
        if handle.sharded:
            outs, dirty, dirty_reason = out
            handle.carry = self._shard_carry(outs)
            mesh = self._shard_mesh
            handle.flags = (mesh.fetch(0, dirty), mesh.fetch(0, dirty_reason))
            return handle.flags
        handle.carry = out[-1]
        handle.flags = (out[5].cpu().numpy(), out[6].cpu().numpy())
        return handle.flags

    @staticmethod
    def _shard_carry(outs) -> tuple:
        """Per-shard kernel outputs → the 9 carry planes, each a tuple of
        the shards' blocks (still on their devices, in shard layout)."""
        return tuple(tuple(o[6][i] for o in outs) for i in range(9))

    def fetch(self, handle: BurstHandle):
        """Block for a launched window's decisions.  Returns the numpy
        tuple (head_row, kind, slot, borrows, tgt_words, dirty,
        dirty_reason) — ``tgt_words`` as uint32 — and parks the final
        carry on the handle for ``dispatch_next``."""
        if handle.decisions is not None:
            return handle.decisions
        t0 = time.perf_counter()
        out = handle.pending
        if handle.sharded:
            handle.decisions = self._fetch_sharded(handle)
        else:
            handle.carry = out[-1]
            dec = [t.cpu().numpy() for t in out[:7]]
            dec[4] = dec[4].view(np.uint32)
            handle.decisions = tuple(dec)
        handle.pending = None
        self._note_forest_activity(handle.plan, handle.decisions[0])
        dt = time.perf_counter() - t0
        if handle.speculative:
            # residual wait not hidden behind the previous window's
            # apply loop — the visible pipelined boundary cost
            self.stats["burst_spec_fetch_wait_s"] += dt
        else:
            self.stats["burst_dispatch_s"] += (
                time.perf_counter() - handle.t_dispatch)
        if os.environ.get("KUEUE_BURST_DEBUG"):
            plan = handle.plan
            print(f"burst fetch K={handle.K} M={plan.M} KC={plan.KC} "
                  f"C={plan.C} dev={handle.dev} "
                  f"spec={handle.speculative}: wait {dt*1e3:.1f} ms",
                  file=sys.stderr)
        return handle.decisions

    def _fetch_sharded(self, handle: BurstHandle) -> tuple:
        """A sharded launch's decisions in global layout: each shard's
        slice is waited for in shard order (the incremental wait lands in
        ``burst_shard_fetch_s``) and read on its stream; the planes come
        back in shard layout [K, S*Cs, ...] and the inverse permutation
        restores the global CQ axis.  tgt_words values need no remap:
        bit j of a CQ's word row refers to candidate slot j, and the
        local tables were value-remapped at identical slot positions."""
        outs, dirty, dirty_reason = handle.pending
        mesh = self._shard_mesh
        handle.carry = self._shard_carry(outs)
        waits = self.stats.get("burst_shard_fetch_s")
        parts = []
        for s, o in enumerate(outs):
            t1 = time.perf_counter()
            mesh.synchronize(s)
            if waits is not None and s < len(waits):
                waits[s] += time.perf_counter() - t1
            parts.append([mesh.fetch(s, t) for t in o[:5]])
        cp = handle.layout.cq_pos
        dec = [np.ascontiguousarray(
            np.concatenate([p[i] for p in parts], axis=1)[:, cp])
            for i in range(5)]
        dec[4] = dec[4].view(np.uint32)
        return tuple(dec) + (mesh.fetch(0, dirty),
                             mesh.fetch(0, dirty_reason))

    def run(self, plan: BurstPlan, K: int, runtime: int,
            ext_release: np.ndarray, ext_unpark: np.ndarray):
        """One fused launch of K cycles, synchronously.  Returns numpy
        decision arrays (head_row, kind, slot, borrows, tgt_words,
        dirty, dirty_reason, u_cq)."""
        handle = self.dispatch(plan, K, runtime, ext_release, ext_unpark)
        decisions = self.fetch(handle)
        if handle.sharded:
            u_cq = self._shard_mesh.gather(handle.carry[-1])
            return decisions + (
                np.ascontiguousarray(u_cq[handle.layout.cq_pos]),)
        return decisions + (handle.carry[-1].cpu().numpy(),)
