"""Streaming delta-pack: patch a persistent packed universe in place.

The classic delta pack (ops/burst.py pack_burst_cached) re-walks only
journal-dirty CQs but still *reassembles* the whole dense ``[C, M]``
plan every window: a full concatenate of the per-CQ row records, three
global lexsorts over every row, a fresh grid allocation + scatter, a
``tolist`` of every key and a rebuilt ``row_of_key`` dict.  All of
that is O(total rows) per window — the host residue that caps the
10k-CQ artifacts.

This module keeps the packed universe *resident on the host* between
windows (cache/arena.py PlaneArena slabs, slab-doubling growth) and
patches it from the PackJournal:

- **dirty CQs** are re-walked (same stage-A ``_pack_cq_rows``) and only
  their grid rows are cleared + rescattered;
- **row-grade touches** (``PackJournal.touch_row``, deduped
  last-writer-wins by ``drain_into``) patch single cells — the dynamic
  bits a check-state flip can move (``vec_ok``, parked, resume) — with
  verify-and-escalate when anything structural moved;
- **global ranks** (``wl_cycle_rank``, ``wl_uidrank``, ``adm_seq0``)
  are maintained as order-statistic updates over sorted key arrays:
  the dirty CQs' entries are deleted and merge-inserted (vectorized
  ``searchsorted`` + ``insert``), and the dense rank planes are
  rewritten only from the first shifted position onward — the
  ``kueue_pack_rank_patches`` gauge counts exactly those rewrites.

The reference sort orders are reproduced bit for bit by encoding each
lexsort key into a fixed-width big-endian byte string (order-preserving
integer/float maps + the ASCII workload key), so one memcmp order
equals the reference ``np.lexsort`` order; non-ASCII or oversized keys
poison the structure back to the classic path (``_StreamBail``).

The produced plan is bit-identical to ``pack_burst`` of the same live
state (enforced by tests/test_streaming_pack.py); plans carry snapshot
*copies* of the live planes, so consumers (pipeline speculation, the
shard-resident scatter, parity tests) never observe later patches.
``KUEUE_TPU_STREAM_PACK=0`` opts out back to the classic delta pack.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from ..cache.arena import PlaneArena
from . import aggregate as _agg
from . import burst as _b
from .packing import _bucket

_KEY_BYTES = 48          # workload key width in the encoded sort keys
_UID_BYTES = 64
_SKEY_DT = np.dtype([("p", ">u8"), ("t", ">u8"), ("o", ">u4"),
                     ("k", f"S{_KEY_BYTES}")])
_SKEY_S = f"S{_SKEY_DT.itemsize}"


class _StreamBail(Exception):
    """This structure can't be streamed (non-ASCII / oversized keys):
    poison it back to the classic pack path."""


def _enc_i64(x: np.ndarray) -> np.ndarray:
    """Order-preserving int64 → uint64 (offset binary)."""
    return x.astype(np.int64).astype(np.uint64) ^ np.uint64(1 << 63)


def _enc_f64(x: np.ndarray) -> np.ndarray:
    """Order-preserving float64 → uint64 (sign-magnitude flip).
    Zeros are canonicalized first: the reference lexsort compares
    -0.0 == 0.0 (tie broken by the next key) and the byte encoding
    must not order them."""
    x = np.asarray(x, dtype=np.float64)
    x = np.where(x == 0.0, 0.0, x)
    b = np.ascontiguousarray(x).view(np.uint64).copy()
    neg = (b >> np.uint64(63)).astype(bool)
    b[neg] = ~b[neg]
    b[~neg] |= np.uint64(1 << 63)
    return b


def _enc_str(arr: np.ndarray, width: int) -> np.ndarray:
    """ASCII-encode a unicode array into fixed-width bytes whose memcmp
    order equals the unicode code-point order; bail when a value can't
    be represented."""
    a = np.asarray(arr, dtype=np.str_)
    if a.size and int(np.char.str_len(a).max(initial=0)) > width:
        raise _StreamBail(f"key longer than {width} bytes")
    try:
        out = np.char.encode(a.astype(f"U{width}"), "ascii")
    except UnicodeEncodeError as e:
        raise _StreamBail("non-ascii key") from e
    return out.astype(f"S{width}")


def _crank_skey(prio, ts, pos, kbytes) -> np.ndarray:
    """Encoded key for the global cycle-order rank: memcmp order ==
    ``np.lexsort((key, pos, ts, -prio))`` order."""
    n = len(kbytes)
    out = np.empty(n, dtype=_SKEY_DT)
    out["p"] = _enc_i64(-np.asarray(prio, dtype=np.int64))
    out["t"] = _enc_f64(ts)
    out["o"] = np.asarray(pos, dtype=np.uint32)
    out["k"] = kbytes
    return out.view(_SKEY_S).reshape(n)


class _Order:
    """A maintained sorted total order: encoded sort keys plus the
    parallel (ci, mi) grid locators of each entry."""
    __slots__ = ("skey", "ci", "mi")

    def __init__(self, dtype):
        self.skey = np.empty(0, dtype=dtype)
        self.ci = np.empty(0, dtype=np.int32)
        self.mi = np.empty(0, dtype=np.int32)

    def set(self, skey, ci, mi):
        srt = np.argsort(skey, kind="stable")
        self.skey = skey[srt]
        self.ci = np.asarray(ci, np.int32)[srt]
        self.mi = np.asarray(mi, np.int32)[srt]

    def update(self, drop_cis, nskey, nci, nmi) -> Optional[int]:
        """Delete every entry of the ``drop_cis`` CQs, merge-insert the
        new entries; returns the first final position whose dense rank
        may have changed (None = order untouched)."""
        first = None
        if len(self.skey) and len(drop_cis):
            dm = np.isin(self.ci, drop_cis)
            if dm.any():
                first = int(np.argmax(dm))
                keep = ~dm
                self.skey = self.skey[keep]
                self.ci = self.ci[keep]
                self.mi = self.mi[keep]
        if len(nskey):
            srt = np.argsort(nskey, kind="stable")
            nskey = nskey[srt]
            nci = np.asarray(nci, np.int32)[srt]
            nmi = np.asarray(nmi, np.int32)[srt]
            pos = np.searchsorted(self.skey, nskey)
            fi = int(pos[0])
            first = fi if first is None else min(first, fi)
            self.skey = np.insert(self.skey, pos, nskey)
            self.ci = np.insert(self.ci, pos, nci)
            self.mi = np.insert(self.mi, pos, nmi)
        return first


# row-plane layout: name -> (pad value, dtype, extra axis: None | "R" | "F")
_ROW_PLANES = {
    "wl_req": (0, np.int32, "R"),
    "wl_rank": (_b.INF_I32, np.int32, None),
    "wl_cycle_rank": (0, np.int32, None),
    "wl_prio": (0, np.int32, None),
    "wl_uidrank": (0, np.int32, None),
    "vec_ok": (False, bool, None),
    "elig0": (False, bool, None),
    "parked0": (False, bool, None),
    "resume0": (0, np.int32, None),
    "adm0": (False, bool, None),
    "adm_seq0": (0, np.int32, None),
    "adm_usage0": (0, np.int32, "F"),
    "adm_uses0": (False, bool, "F"),
    "death0": (_b.I32_MAX, np.int32, None),   # constant plane
}


class StreamState:
    """Persistent streaming pack state, duck-compatible with
    ``DeltaPackState`` (key/records/fields/token) so the classic path
    can consume it after an opt-out or poison."""
    __slots__ = ("key", "records", "fields", "token", "arena",
                 "crank", "uord",
                 "adm_ts", "adm_ci", "adm_mi", "adm_seq_cache",
                 "mi_of", "kb_of",
                 "n_rows_cq", "n_pend_cq", "maxabs_prio_cq", "bad_cq",
                 "strict_cq", "pos_cq", "cq_names_list",
                 "n_comp_cq", "comp_max_cq",
                 "row_of_key", "keys_grid", "M")

    def __init__(self, key, arena):
        self.key = key
        self.fields = None        # classic-path compatibility
        self.arena = arena
        self.token = next(_b.DeltaPackState._next_token)


def _views(arena: PlaneArena, C: int, M: int, R: int, F: int) -> dict:
    out = {}
    for name, (pad, dt, extra) in _ROW_PLANES.items():
        shape = (C, M) if extra is None else \
            (C, M, R) if extra == "R" else (C, M, F)
        out[name] = arena.ensure(name, shape, dt, pad)
    out["u_cq0"] = arena.ensure("u_cq0", (C, F), np.int32, 0, grow_axes=1)
    out["keys_grid"] = arena.ensure("keys_grid", (C, M), object, None)
    out["agg_heads"] = arena.ensure("agg_heads", (C,), np.int32, 0)
    out["agg_rows"] = arena.ensure("agg_rows", (C,), np.int32, 0)
    out["agg_comp"] = arena.ensure("agg_comp", (C,), np.int32, 0)
    out["agg_comp_ts"] = arena.ensure("agg_comp_ts", (C,),
                                      np.float64, -1.0)
    out["agg_best_prio"] = arena.ensure("agg_best_prio", (C,),
                                        np.int32, 0)
    out["agg_best_ts"] = arena.ensure("agg_best_ts", (C,),
                                      np.float64, -1.0)
    return out


def _reset_views(views: dict) -> None:
    for name, v in views.items():
        if name == "keys_grid":
            pad = None
        elif name == "u_cq0":
            pad = 0
        elif name in _agg.AGG_PLANES:
            pad = _agg.AGG_PLANES[name][0]
        else:
            pad = _ROW_PLANES[name][0]
        base = v
        while base.base is not None:
            base = base.base
        base[...] = pad


def _clear_cq(state: "StreamState", views: dict, ci: int) -> None:
    """Reset one CQ's grid rows to pad across the FULL slab width, so
    later M growth exposes pads, and unindex its keys."""
    for name, (pad, _, _) in _ROW_PLANES.items():
        if name == "death0":
            continue
        slab = views[name]
        base = slab
        while base.base is not None:
            base = base.base
        base[ci] = pad
    views["u_cq0"][ci] = 0
    _agg.agg_clear_cq(views, ci)
    kg = views["keys_grid"]
    base = kg
    while base.base is not None:
        base = base.base
    base[ci] = None
    old = state.records[ci]
    if old is not None:
        for k in old.index_of_key:
            state.row_of_key.pop(k, None)


def _write_cq(state: "StreamState", views: dict, ci: int, rec,
              mi: np.ndarray) -> None:
    """Scatter one CQ's freshly walked record into the grid planes
    (the per-row half; global rank planes are patched separately)."""
    if rec.n_rows:
        views["wl_req"][ci, mi] = rec.req
        views["wl_rank"][ci, mi] = mi
        views["wl_prio"][ci, mi] = np.clip(
            rec.prio, -_b.I32_MAX, _b.I32_MAX)
        views["vec_ok"][ci, mi] = rec.ok
        views["parked0"][ci, mi] = rec.parked
        views["elig0"][ci, mi] = ~rec.parked & ~rec.adm
        views["resume0"][ci, mi] = rec.resume
        views["adm0"][ci, mi] = rec.adm
        views["adm_usage0"][ci, mi] = rec.usage
        views["adm_uses0"][ci, mi] = rec.uses
        keys = rec.keys.tolist()
        views["keys_grid"][ci, mi] = np.array(keys, dtype=object)
        row_of = state.row_of_key
        for k, m in zip(keys, mi.tolist()):
            row_of[k] = (ci, int(m))
    views["u_cq0"][ci] = rec.u_row
    _agg.agg_write_cq(views, ci, rec)


def _cq_mi(rec) -> np.ndarray:
    """Per-CQ heap rank — the ci-segment of the reference global
    ``lexsort((key, ts, -prio, ci))`` (total order via the unique key
    tiebreak, so the segmented and per-CQ sorts agree exactly)."""
    mi = np.empty(rec.n_rows, dtype=np.int32)
    mi[np.lexsort((rec.keys, rec.ts, -rec.prio))] = \
        np.arange(rec.n_rows, dtype=np.int32)
    return mi


_ESCALATE = object()


def _row_patch_job(state, st, queues, cache, scheduler, ci, key):
    """Re-derive one row's dynamic bits (parked / resume / vec_ok) from
    the live queue + cache state.  Returns None (nothing moved), a
    ``(ci, idx, parked, resume, ok)`` patch, or ``_ESCALATE`` when the
    change is beyond row grade (membership, identity, admission)."""
    from ..api.types import AdmissionCheckState
    from .solver import resume_start
    rec = state.records[ci]
    idx = rec.index_of_key.get(key)
    if idx is None:
        # benign absences: below a window-truncation cutoff, or an
        # aggregate-compressed admitted row (its only row-grade bit,
        # vec_ok, never reaches the kernel — no candidates are drawn
        # from a compressible forest).  Membership changes always come
        # through hard journal touches, which dirty the CQ before row
        # jobs run, so an unknown key here can't be a new workload.
        return None if (rec.truncated or rec.n_comp) else _ESCALATE
    cq_name = st.cq_names[ci]
    q = queues.queue_for(cq_name)
    cq_live = cache.cluster_queue(cq_name)
    if cq_live is None:
        return _ESCALATE
    covers_pods = cq_name in st.cq_covers_pods
    cq_ok = st.cq_vector_ok
    cq_vec = bool(cq_ok[ci]) if cq_ok is not None else False
    if cq_vec and cq_live.spec.namespace_selector:
        cq_vec = False
    if idx >= rec.n_pend:
        # admitted row: only the vec_ok gate can move at row grade
        info = rec.infos[idx]
        if cq_live.workloads.get(key) is not info:
            return _ESCALATE
        obj = info.obj
        from ..api.types import WL_EVICTED, WL_QUOTA_RESERVED
        if (obj.condition_true(WL_EVICTED)
                or obj.conditions.get(WL_QUOTA_RESERVED) is None):
            return _ESCALATE
        row = getattr(info, "_burst_row", None)
        if row is None or row[0] != st.generation:
            return _ESCALATE
        ok = cq_vec and row[3]
        if ok:
            lr = scheduler.limit_range_summaries
            if lr and lr.get(obj.namespace):
                ok = False
            elif obj.admission_check_states and any(
                    s.state in (AdmissionCheckState.RETRY,
                                AdmissionCheckState.REJECTED)
                    for s in obj.admission_check_states.values()):
                ok = False
        if ok == bool(rec.ok[idx]):
            return None
        return (ci, idx, bool(rec.parked[idx]), int(rec.resume[idx]), ok)
    if q is None or not q.active:
        return _ESCALATE
    parked_now = False
    info = q.heap.get(key)
    if info is None:
        info = q.inadmissible.get(key)
        if info is None:
            return _ESCALATE
        rs = info.obj.requeue_state
        if rs is not None and rs.requeue_at is not None:
            return _ESCALATE   # backoff-parked: membership changed
        parked_now = True
    if rec.infos[idx] is not info:
        return _ESCALATE
    row = getattr(info, "_burst_row", None)
    if row is None or row[0] != st.generation:
        return _ESCALATE
    obj = info.obj
    ok = cq_vec and row[3]
    if ok:
        lr = scheduler.limit_range_summaries
        if lr and lr.get(obj.namespace):
            ok = False
        elif key in cache.assumed_workloads or obj.admission is not None:
            ok = False
        elif obj.admission_check_states and any(
                s.state in (AdmissionCheckState.RETRY,
                            AdmissionCheckState.REJECTED)
                for s in obj.admission_check_states.values()):
            ok = False
    resume_now = resume_start(info, cq_live, covers_pods)
    if (parked_now == bool(rec.parked[idx])
            and resume_now == int(rec.resume[idx])
            and ok == bool(rec.ok[idx])):
        return None
    return (ci, idx, parked_now, resume_now, ok)


def _bump(stats, key, n=1):
    if stats is not None:
        stats[key] = stats.get(key, 0) + n


def _materialize(st, state, s, views, scheduler, dirty_cis, prev_token,
                 rank_patches, stats):
    """Build the BurstPlan snapshot from the patched arena state."""
    C = len(st.cq_names)
    M = state.M
    n = int(state.n_rows_cq.sum())
    L, G = s.L, st.n_forests
    KC = min(_b.KC_CAP, ((L * M + 31) // 32) * 32)
    # seq_base / max_res_ts from the maintained admitted-ts multiset;
    # max_res_ts (the driver's admission clock) must also cover
    # aggregate-compressed admitted rows, whose reservation times live
    # only in the per-CQ comp_max_cq aggregate
    if len(state.adm_ts):
        uniq = np.unique(state.adm_ts)
        seq_base = int(len(uniq)) + 2
        max_res_ts = float(state.adm_ts[-1])
    else:
        seq_base = 2
        max_res_ts = None
    comp_max = float(state.comp_max_cq.max(initial=-np.inf))
    if np.isfinite(comp_max):
        max_res_ts = (comp_max if max_res_ts is None
                      else max(max_res_ts, comp_max))
    forest_bad = s.deep.copy()
    bad_idx = np.nonzero(state.bad_cq)[0]
    if len(bad_idx):
        forest_bad[s.forest_of_cq[bad_idx]] = True
    if L * M > KC:
        forest_bad[:] = True
    if not scheduler.ordering.priority_sorting_within_cohort:
        forest_bad[:] = True
    # budget scoping mirrors _assemble_plan: with head-pack on, only
    # rows of preempting forests can ever be candidate-encoded, so only
    # they are charged against the 19/20-bit composite-key fields
    if _agg.head_pack_enabled():
        bm = ~s.comp_cq
        n_budget = int(state.n_rows_cq[bm].sum())
        prio_budget = int(state.maxabs_prio_cq[bm].max(initial=0))
    else:
        n_budget = n
        prio_budget = int(state.maxabs_prio_cq.max(initial=0))
    if (prio_budget >= (1 << 20)
            or seq_base + max(_b.K_BURST_LADDER) >= (1 << 20)
            or n_budget >= (1 << 19)):
        forest_bad[:] = True
    preempt_ok = s.modelable_base & ~forest_bad[s.forest_of_cq]
    tables = s.cand_tables.get((M, KC))
    if tables is None:
        tables = _b.build_candidate_tables(s.forest_of_cq, s.members,
                                           M, KC)
        s.cand_tables[(M, KC)] = tables
    cand_rows, cand_lmem, self_lmem = tables
    arrays = {name: views[name].copy()
              for name in _ROW_PLANES}
    arrays["u_cq0"] = views["u_cq0"].copy()
    arrays.update(
        potential0=s.potential0, subtree=st.subtree_quota,
        guaranteed=st.guaranteed, borrow_cap=st.borrow_cap,
        has_blim=st.has_borrow_limit, parent=st.parent,
        node_level=s.node_level, nominal_cq=st.nominal_cq,
        npb_cq=st.nominal_plus_blimit_cq, slot_fr=st.slot_fr,
        slot_valid=st.slot_valid,
        cq_can_preempt_borrow=st.cq_can_preempt_borrow,
        cq_wcb_borrow=st.cq_wcb_borrow,
        cq_wcp_preempt=st.cq_wcp_preempt,
        forest_of_cq=s.forest_of_cq,
        strict_cq=state.strict_cq.copy(),
        wcq_lower=s.wcq_lower, rwc_enabled=s.rwc_enabled,
        rwc_only_lower=s.rwc_only_lower, preempt_ok=preempt_ok,
        members=s.members, cand_rows=cand_rows, cand_lmem=cand_lmem,
        self_lmem=self_lmem)
    plan = _b.BurstPlan(
        structure=st, arrays=arrays,
        keys=_KeysView(views["keys_grid"].copy()),
        C=C, M=M, L=L, G=G, n_levels=s.n_levels, KC=KC,
        seq_base=seq_base, row_of_key=state.row_of_key,
        max_res_ts=max_res_ts,
        budget_rows=n_budget, grid_rows=n)
    plan.pack_token = state.token
    plan.prev_token = prev_token
    if dirty_cis is not None:
        plan.dirty_cqs = np.asarray(sorted(dirty_cis), dtype=np.int64)
        from ..utils.journal import PackJournal
        plan.dirty_ranges = PackJournal.coalesce(sorted(dirty_cis))
    if stats is not None:
        stats["pack_rank_patches"] = (
            stats.get("pack_rank_patches", 0) + int(rank_patches))
        shapes = {name: a.shape for name, a in arrays.items()
                  if name in _ROW_PLANES or name == "u_cq0"}
        state.arena.refresh_stats(shapes)
        stats.update({("pack_" + k): v
                      for k, v in state.arena.stats.items()})
        stats.update(_agg.agg_summary(state, s.comp_cq))
        stats["head_pack_budget_rows"] = n_budget
        stats["head_pack_exempt_rows"] = n - n_budget
    return plan


class _KeysView:
    """Lazy ``plan.keys``: an object grid supporting the consumers'
    ``plan.keys[ci][mi]`` indexing without materializing C×M Python
    lists every window.  Equality compares against list-of-lists (the
    classic plan shape) for the parity tests."""
    __slots__ = ("_g",)

    def __init__(self, grid):
        self._g = grid

    def __getitem__(self, ci):
        return self._g[ci]

    def __len__(self):
        return len(self._g)

    def __iter__(self):
        return iter(self._g)

    def tolist(self):
        return self._g.tolist()

    def __eq__(self, other):
        if isinstance(other, _KeysView):
            return self._g.tolist() == other._g.tolist()
        if isinstance(other, list):
            return self._g.tolist() == other
        return NotImplemented

    def __ne__(self, other):
        eq = self.__eq__(other)
        return eq if eq is NotImplemented else not eq


def _init_full(st, queues, cache, scheduler, key, min_m, window, arena,
               stats, t0):
    """Full streaming (re)build: walk every CQ, reset + refill the
    arena, rebuild the maintained orders.  The assembly math mirrors
    ops/burst._assemble_plan line for line — same sorts, same pads —
    so the first streaming plan equals the reference plan bit for bit."""
    if _b._unknown_active_cq(st, queues):
        return None, None, False
    records = _b._walk_records(st, queues, cache, scheduler, window)
    if records is None:
        return None, None, False
    C = len(st.cq_names)
    R = len(st.resource_names)
    F = max(1, len(st.fr_index))
    s = _b._pack_statics(st, cache)

    state = StreamState(key, arena)
    state.records = records
    state.cq_names_list = list(queues.cluster_queue_names())
    pos_of = {name: i for i, name in enumerate(state.cq_names_list)}
    state.pos_cq = np.fromiter(
        (pos_of.get(nm, C) for nm in st.cq_names), np.int32, C)
    for rec in records:
        rec.pos = int(state.pos_cq[rec.ci])
    state.n_rows_cq = np.fromiter((r.n_rows for r in records),
                                  np.int64, C)
    state.n_pend_cq = np.fromiter((r.n_pend for r in records),
                                  np.int64, C)
    state.bad_cq = np.fromiter((r.bad for r in records), bool, C)
    state.strict_cq = np.fromiter((r.strict for r in records), bool, C)
    state.n_comp_cq = np.fromiter((r.n_comp for r in records),
                                  np.int64, C)
    state.comp_max_cq = np.fromiter((r.comp_max_ts for r in records),
                                    np.float64, C)
    bounds = np.concatenate(([0], np.cumsum(state.n_rows_cq)))
    n = int(bounds[-1])

    nz = [r for r in records if r.n_rows]
    def cat(attr, empty_dtype):
        if nz:
            return np.concatenate([getattr(r, attr) for r in nz])
        return np.empty(0, dtype=empty_dtype)
    keys_a = cat("keys", "U1")
    uids_a = cat("uids", "U1")
    prio_a = cat("prio", np.int64)
    ts_a = cat("ts", np.float64)
    res_ts_a = cat("res_ts", np.float64)
    adm_a = cat("adm", bool)
    kb_all = _enc_str(keys_a, _KEY_BYTES)      # may bail -> caller
    ub_all = _enc_str(uids_a, _UID_BYTES)
    ci_a = np.repeat(np.arange(C, dtype=np.int32), state.n_rows_cq)
    pos_a = np.repeat(state.pos_cq, state.n_rows_cq)

    # per-CQ |prio| maxima (reduceat; empty segments masked out)
    state.maxabs_prio_cq = np.zeros(C, np.int64)
    if n:
        red = np.maximum.reduceat(
            np.abs(prio_a), np.minimum(bounds[:-1], n - 1))
        state.maxabs_prio_cq = np.where(state.n_rows_cq > 0, red, 0)

    rows_per_cq = int(state.n_rows_cq.max(initial=0))
    state.M = M = max(_bucket(rows_per_cq, minimum=4), min_m)
    views = _views(arena, C, M, R, F)
    _reset_views(views)

    # per-CQ heap rank: the reference ci-segmented lexsort
    order = np.lexsort((keys_a, ts_a, -prio_a, ci_a))
    ci_sorted = ci_a[order]
    first = np.ones(n, dtype=bool)
    first[1:] = ci_sorted[1:] != ci_sorted[:-1]
    idx = np.arange(n, dtype=np.int32)
    seg_start = np.maximum.accumulate(np.where(first, idx, np.int32(0)))
    mi_sorted = idx - seg_start
    mi_a = np.empty(n, dtype=np.int32)
    mi_a[order] = mi_sorted

    state.mi_of = {}
    state.kb_of = {}
    for ci in range(C):
        lo, hi = int(bounds[ci]), int(bounds[ci + 1])
        state.mi_of[ci] = mi_a[lo:hi]
        state.kb_of[ci] = kb_all[lo:hi]

    if n:
        views["wl_req"][ci_a, mi_a] = cat("req", np.int32)
        views["wl_rank"][ci_a, mi_a] = mi_a
        views["wl_prio"][ci_a, mi_a] = np.clip(
            prio_a, -_b.I32_MAX, _b.I32_MAX)
        parked_a = cat("parked", bool)
        views["parked0"][ci_a, mi_a] = parked_a
        views["elig0"][ci_a, mi_a] = ~parked_a & ~adm_a
        views["vec_ok"][ci_a, mi_a] = cat("ok", bool)
        views["resume0"][ci_a, mi_a] = cat("resume", np.int32)
        views["adm0"][ci_a, mi_a] = adm_a
        views["adm_usage0"][ci_a, mi_a] = cat("usage", np.int32)
        views["adm_uses0"][ci_a, mi_a] = cat("uses", bool)
        key_list = keys_a.tolist()
        views["keys_grid"][ci_a, mi_a] = np.array(key_list, dtype=object)
        state.row_of_key = dict(zip(
            key_list, zip(ci_a.tolist(), mi_a.tolist())))
    else:
        state.row_of_key = {}
    for ci, rec in enumerate(records):
        views["u_cq0"][ci] = rec.u_row
    _agg.agg_fill(views, records)

    # maintained global orders + their dense rank planes
    state.crank = _Order(_SKEY_S)
    state.crank.set(_crank_skey(prio_a, ts_a, pos_a, kb_all),
                    ci_a, mi_a)
    if n:
        views["wl_cycle_rank"][state.crank.ci, state.crank.mi] = \
            np.arange(n, dtype=np.int32)
    # head-pack: the uid order (and so the 19-bit uidrank field) only
    # tracks budget rows — rows of preempting forests; exempt rows keep
    # the pad rank 0, which the kernel never reads for them (candidate
    # eligibility needs the head's wcq_lower/rwc_enabled census bits)
    state.uord = _Order(f"S{_UID_BYTES}")
    if _agg.head_pack_enabled() and n:
        bsel = np.nonzero(~s.comp_cq[ci_a])[0]
        state.uord.set(ub_all[bsel], ci_a[bsel], mi_a[bsel])
    else:
        state.uord.set(ub_all, ci_a, mi_a)
    n_uord = len(state.uord.ci)
    if n_uord:
        views["wl_uidrank"][state.uord.ci, state.uord.mi] = \
            np.arange(n_uord, dtype=np.int32)
    am = np.nonzero(adm_a)[0]
    ats = res_ts_a[am]
    aord = np.argsort(ats, kind="stable")
    state.adm_ts = ats[aord]
    state.adm_ci = ci_a[am][aord]
    state.adm_mi = mi_a[am][aord]
    if len(state.adm_ts):
        uniq = np.unique(state.adm_ts)
        state.adm_seq_cache = (np.searchsorted(uniq, state.adm_ts)
                               + 1).astype(np.int32)
        views["adm_seq0"][state.adm_ci, state.adm_mi] = \
            state.adm_seq_cache
    else:
        state.adm_seq_cache = np.empty(0, np.int32)

    _bump(stats, "burst_full_packs")
    _bump(stats, "stream_full_packs")
    _bump(stats, "rows_repacked", n)
    if int(state.n_pend_cq.sum()) == 0:
        _note_ms(stats, t0)
        return None, state, False
    plan = _materialize(st, state, s, views, scheduler, None,
                        None, 0, stats)
    _note_ms(stats, t0)
    return plan, state, False


def _note_ms(stats, t0, delta=False):
    if stats is not None:
        dt = time.perf_counter() - t0
        stats["stream_pack_s"] = stats.get("stream_pack_s", 0.0) + dt
        stats["pack_last_ms"] = dt * 1e3
        if delta:
            # classic-path compat: tooling reads delta_pack_s as "time
            # spent on incremental (non-full) packs"
            stats["delta_pack_s"] = stats.get("delta_pack_s", 0.0) + dt


def pack_burst_streaming(structure, queues, cache, scheduler, clock,
                         state=None, min_m: int = 0, window: int = 0,
                         stats=None):
    """Streaming counterpart of ``pack_burst_cached``; same return
    contract ``(plan, state, was_delta)``, bit-identical plans."""
    st = structure
    t0 = time.perf_counter()
    key = (st.generation, st.resource_scale.tobytes(),
           tuple(st.cq_names), window, _agg.agg_planes_enabled())
    dirty: set = set()
    soft: dict = {}
    rows: dict = {}
    jranges: list = []
    force_full = False
    for j in (getattr(queues, "pack_journal", None),
              getattr(cache, "pack_journal", None)):
        if j is None:
            force_full = True
        else:
            force_full |= j.drain_into(dirty, soft, row_of=st.cq_index,
                                       ranges_out=jranges, rows_out=rows)
    arena = getattr(cache, "_pack_arena", None)
    if arena is None:
        arena = cache._pack_arena = PlaneArena()

    try:
        if (not isinstance(state, StreamState) or state.key != key
                or force_full):
            return _init_full(st, queues, cache, scheduler, key, min_m,
                              window, arena, stats, t0)

        index_of = st.cq_index
        C = len(st.cq_names)
        for name in set(dirty) | set(soft) | set(rows.values()):
            if name not in index_of:
                q = queues.queue_for(name)
                if q is not None and q.active and q.pending_active():
                    return None, None, False
        for name, skeys in soft.items():
            ci = index_of.get(name)
            if ci is None or name in dirty:
                continue
            if not _b._roundtrips_clean(
                    state.records[ci], queues.queue_for(name),
                    cache.cluster_queue(name), skeys,
                    name in st.cq_covers_pods):
                dirty.add(name)
        row_jobs = []
        rows_verified = 0
        for wkey, name in rows.items():
            ci = index_of.get(name)
            if ci is None or name in dirty:
                continue
            job = _row_patch_job(state, st, queues, cache, scheduler,
                                 ci, wkey)
            if job is _ESCALATE:
                dirty.add(name)
            elif job is not None:
                row_jobs.append(job)
            else:
                rows_verified += 1
        if rows_verified:
            _bump(stats, "pack_rows_verified", rows_verified)

        if len(dirty) > max(_b._DELTA_MIN_DIRTY_CQS,
                            _b._DELTA_MAX_DIRTY_FRAC * C):
            return _init_full(st, queues, cache, scheduler, key, min_m,
                              window, arena, stats, t0)

        # heads-enumeration position drift (CQs joined/left the queue
        # manager without a structure change): the crank sort keys of
        # every row of a moved CQ change, nothing else does
        pos_dirty_cis: list = []
        names_now = queues.cluster_queue_names()
        if state.cq_names_list != names_now:
            pos_of = {nm: i for i, nm in enumerate(names_now)}
            newpos = np.fromiter(
                (pos_of.get(nm, C) for nm in st.cq_names), np.int32, C)
            for ci in np.nonzero(newpos != state.pos_cq)[0]:
                ci = int(ci)
                pos_dirty_cis.append(ci)
                state.records[ci].pos = int(newpos[ci])
            state.pos_cq = newpos
            state.cq_names_list = list(names_now)

        # stage A over the dirty CQs only; encode before mutating so a
        # bail leaves the state coherent
        assumed = cache.assumed_workloads
        scale_of = {r: int(st.resource_scale[i])
                    for i, r in enumerate(st.resource_names)}
        statics = _b._pack_statics(st, cache)
        comp_cq = (statics.comp_cq if _agg.agg_planes_enabled()
                   else None)
        def _walk_one(ci):
            rec = _b._pack_cq_rows(st, ci, int(state.pos_cq[ci]),
                                   queues, cache, scheduler, assumed,
                                   scale_of, window,
                                   compress=(comp_cq is not None
                                             and bool(comp_cq[ci])))
            if rec is _b._PACK_FAIL:
                return None
            kb = _enc_str(rec.keys, _KEY_BYTES)
            ub = _enc_str(rec.uids, _UID_BYTES)
            return (ci, rec, kb, ub, _cq_mi(rec))

        cis = sorted(ci for name in dirty
                     if (ci := index_of.get(name)) is not None)
        # stage A is per-CQ pure (each walk reads shared structure and
        # writes only its own CQ's rows/memos), so the host pool fans
        # the dirty walk out by cohort forest; the gather is in
        # ascending (forest, ci) order, and every downstream merge is
        # order-insensitive (sorted-order updates, disjoint row writes),
        # so pooled and serial walks build identical states
        pool = getattr(cache, "host_pool", None)
        if pool is not None and pool.active and len(cis) >= 2:
            fcq = statics.forest_of_cq
            parts = pool.map_partitions(
                cis, lambda ci: int(fcq[ci]),
                lambda g, part: [_walk_one(ci) for ci in part])
            walked = [w for part in parts for w in part]
        else:
            walked = [_walk_one(ci) for ci in cis]
        if any(w is None for w in walked):
            return None, None, False

        for ci, rec, kb, ub, mi in walked:
            state.n_rows_cq[ci] = rec.n_rows
            state.n_pend_cq[ci] = rec.n_pend
            state.bad_cq[ci] = rec.bad
            state.strict_cq[ci] = rec.strict
            state.n_comp_cq[ci] = rec.n_comp
            state.comp_max_cq[ci] = rec.comp_max_ts
            state.maxabs_prio_cq[ci] = int(
                np.abs(rec.prio).max(initial=0))
        rows_per_cq = int(state.n_rows_cq.max(initial=0))
        state.M = M = max(_bucket(rows_per_cq, minimum=4), min_m)
        R = len(st.resource_names)
        F = max(1, len(st.fr_index))
        views = _views(arena, C, M, R, F)

        for ci, rec, kb, ub, mi in walked:
            _clear_cq(state, views, ci)
            _write_cq(state, views, ci, rec, mi)
            state.records[ci] = rec
            state.mi_of[ci] = mi
            state.kb_of[ci] = kb

        rank_patches = 0
        # cycle-order rank: drop dirty + pos-moved CQ entries, merge the
        # fresh ones back in, rewrite the dense rank suffix
        walked_cis = [w[0] for w in walked]
        crank_drop = np.asarray(walked_cis + pos_dirty_cis, np.int32)
        ins_sk, ins_ci, ins_mi = [], [], []
        for ci, rec, kb, ub, mi in walked:
            if rec.n_rows:
                ins_sk.append(_crank_skey(
                    rec.prio, rec.ts,
                    np.full(rec.n_rows, state.pos_cq[ci], np.int64), kb))
                ins_ci.append(np.full(rec.n_rows, ci, np.int32))
                ins_mi.append(mi)
        for ci in pos_dirty_cis:
            rec = state.records[ci]
            if rec.n_rows:
                ins_sk.append(_crank_skey(
                    rec.prio, rec.ts,
                    np.full(rec.n_rows, state.pos_cq[ci], np.int64),
                    state.kb_of[ci]))
                ins_ci.append(np.full(rec.n_rows, ci, np.int32))
                ins_mi.append(state.mi_of[ci])
        sfrom = state.crank.update(
            crank_drop,
            np.concatenate(ins_sk) if ins_sk
            else np.empty(0, _SKEY_S),
            np.concatenate(ins_ci) if ins_ci else (),
            np.concatenate(ins_mi) if ins_mi else ())
        if sfrom is not None:
            ntot = len(state.crank.skey)
            views["wl_cycle_rank"][
                state.crank.ci[sfrom:], state.crank.mi[sfrom:]] = \
                np.arange(sfrom, ntot, dtype=np.int32)
            rank_patches += ntot - sfrom

        # uid rank: same mechanism, dirty CQs only; head-pack keeps
        # exempt (never-candidate) CQs out of the maintained uid order,
        # mirroring the _init_full budget filter
        head_pack = _agg.head_pack_enabled()
        ins_sk, ins_ci, ins_mi = [], [], []
        for ci, rec, kb, ub, mi in walked:
            if rec.n_rows and not (head_pack and statics.comp_cq[ci]):
                ins_sk.append(ub)
                ins_ci.append(np.full(rec.n_rows, ci, np.int32))
                ins_mi.append(mi)
        sfrom = state.uord.update(
            np.asarray(walked_cis, np.int32),
            np.concatenate(ins_sk) if ins_sk
            else np.empty(0, f"S{_UID_BYTES}"),
            np.concatenate(ins_ci) if ins_ci else (),
            np.concatenate(ins_mi) if ins_mi else ())
        if sfrom is not None:
            ntot = len(state.uord.skey)
            views["wl_uidrank"][
                state.uord.ci[sfrom:], state.uord.mi[sfrom:]] = \
                np.arange(sfrom, ntot, dtype=np.int32)
            rank_patches += ntot - sfrom

        # admitted reservation-seq: maintain the sorted ts multiset,
        # recompute dense seqs vectorized, scatter only changed cells
        if walked:
            wset = np.asarray(walked_cis, np.int32)
            keep = ~np.isin(state.adm_ci, wset) \
                if len(state.adm_ci) else np.empty(0, bool)
            a_ts = state.adm_ts[keep]
            a_ci = state.adm_ci[keep]
            a_mi = state.adm_mi[keep]
            a_sq = state.adm_seq_cache[keep]
            nts, nci, nmi = [], [], []
            for ci, rec, kb, ub, mi in walked:
                if rec.n_adm:
                    am = rec.adm
                    nts.append(rec.res_ts[am])
                    nci.append(np.full(int(am.sum()), ci, np.int32))
                    nmi.append(mi[am])
            if nts:
                nts = np.concatenate(nts)
                srt = np.argsort(nts, kind="stable")
                nts = nts[srt]
                nci = np.concatenate(nci)[srt]
                nmi = np.concatenate(nmi)[srt]
                pos = np.searchsorted(a_ts, nts)
                a_ts = np.insert(a_ts, pos, nts)
                a_ci = np.insert(a_ci, pos, nci)
                a_mi = np.insert(a_mi, pos, nmi)
                a_sq = np.insert(a_sq, pos,
                                 np.full(len(nts), -1, np.int32))
            state.adm_ts, state.adm_ci, state.adm_mi = a_ts, a_ci, a_mi
            if len(a_ts):
                uniq = np.unique(a_ts)
                seq_all = (np.searchsorted(uniq, a_ts)
                           + 1).astype(np.int32)
                chg = seq_all != a_sq
                if chg.any():
                    views["adm_seq0"][a_ci[chg], a_mi[chg]] = \
                        seq_all[chg]
                    rank_patches += int(chg.sum())
                state.adm_seq_cache = seq_all
            else:
                state.adm_seq_cache = np.empty(0, np.int32)

        # row-grade patches (deduped by the journal): single cells.
        # A job queued before a later row escalated its CQ to dirty is
        # stale — the re-walk rebuilt the record (and row order), so its
        # idx no longer addresses the row it was derived from.
        wset_cis = set(walked_cis)
        row_jobs = [j for j in row_jobs if j[0] not in wset_cis]
        for ci, idx, parked_now, resume_now, ok_now in row_jobs:
            rec = state.records[ci]
            mi = int(state.mi_of[ci][idx])
            rec.parked[idx] = parked_now
            rec.resume[idx] = resume_now
            rec.ok[idx] = ok_now
            views["parked0"][ci, mi] = parked_now
            views["elig0"][ci, mi] = (not parked_now
                                      and not bool(rec.adm[idx]))
            views["resume0"][ci, mi] = resume_now
            views["vec_ok"][ci, mi] = ok_now
        _bump(stats, "pack_row_patches", len(row_jobs))

        prev_token = state.token
        state.token = next(_b.DeltaPackState._next_token)
        repacked = sum(r.n_rows for _, r, _, _, _ in walked)
        _bump(stats, "burst_delta_packs")
        _bump(stats, "stream_packs")
        _bump(stats, "rows_repacked", repacked)
        _bump(stats, "rows_reused",
              int(state.n_rows_cq.sum()) - repacked)
        _bump(stats, "burst_journal_dirty_ranges", len(jranges))

        if int(state.n_pend_cq.sum()) == 0:
            _note_ms(stats, t0)
            return None, state, False
        s = _b._pack_statics(st, cache)
        dirty_cis = set(walked_cis) | {j[0] for j in row_jobs}
        plan = _materialize(st, state, s, views, scheduler, dirty_cis,
                            prev_token, rank_patches, stats)
        _note_ms(stats, t0, delta=True)
        return plan, state, True
    except _StreamBail:
        st._stream_poison = True
        _bump(stats, "stream_pack_bails")
        return _b._pack_burst_cached_classic(
            structure, queues, cache, scheduler, clock, state=None,
            min_m=min_m, window=window, stats=stats)
