"""Cohort-forest aggregate planes (the hierarchical compression layer).

The fused burst kernel's per-row work is bounded by the packed row
count, and before this layer every admitted workload owned a packed
row — so kernel cost scaled with *live workloads* and the composite
candidate-key encoding capped the pack at 2^19 rows.  But an admitted
row is only ever *read* by the kernel as a preemption candidate, and
candidates are drawn strictly from the head's own cohort forest
(``cand_rows[forest_of_cq[c]]``; ops/burst.py eligibility).  A forest
in which no member CQ can preempt (no ``withinClusterQueue:
LowerPriority``, no ``reclaimWithinCohort``) therefore never reads its
admitted rows at all: their only kernel effects are (a) the CQ usage
they hold — already aggregated in the ``u_cq0`` plane — and (b) the
release pulse when one finishes mid-burst — already routed through the
driver's ``ext_release`` fallback for unpacked keys.

``compressible_cqs`` identifies exactly those forests; the pack then
keeps their admitted workloads *out of the row planes* and tracks them
in per-CQ aggregates instead (count + max reservation time, maintained
incrementally by the streaming delta-pack).  Packed-row count — and
with it kernel cycle time and the 2^19 ceiling — scales with active
CQs + queue heads, not live workloads.  ``KUEUE_TPU_AGG_PLANES=0``
opts out; the uncompressed arm is the parity oracle (decisions are
bit-identical by the argument above, test-enforced).
"""

from __future__ import annotations

import numpy as np

from ..features import env_value

# aggregate plane layout: name -> (pad value, dtype); all [C]-shaped,
# arena-resident, maintained by the streaming pack alongside the row
# planes (registered in analysis/dtypes.PLANE_SCHEMA)
AGG_PLANES = {
    "agg_heads": (0, np.int32),        # pending (head-eligible) rows
    "agg_rows": (0, np.int32),         # rows actually packed
    "agg_comp": (0, np.int32),         # admitted rows compressed out
    "agg_comp_ts": (-1.0, np.float64),  # max reservation ts compressed
    "agg_best_prio": (0, np.int32),    # best head's priority per lane
    "agg_best_ts": (-1.0, np.float64),  # best head's queue-order ts
}


def agg_planes_enabled() -> bool:
    return env_value("KUEUE_TPU_AGG_PLANES") != "0"


def head_pack_enabled() -> bool:
    """Head-only packing (``KUEUE_TPU_HEAD_PACK``, default on).

    The same forest census that makes admitted rows compressible makes
    *pending* rows budget-exempt: a pending row of a never-preempting
    forest can win its own CQ's head slot (a per-CQ lexsort, no
    composite key involved) but can never be gathered as a preemption
    candidate — candidate eligibility requires the head CQ's
    ``wcq_lower``/``rwc_enabled``, which no member of such a forest
    has, and ineligible candidates sort behind every eligible one via
    key_hi bit 30.  So the kernel's 19-bit uid rank and the 2^19/2^20
    poison gates only need to cover rows of *preempting* forests
    ("budget rows"); everything else rides along as rank context.
    Kernel row *budget* then scales with preempting-forest rows, not
    active CQs — the r19 ceiling lift.  The scoped uid rank is the
    subset rank (order-preserving), so candidate ordering — hence every
    decision — is bit-identical to the row-backed arm (test-enforced
    in tests/test_head_packing.py)."""
    return env_value("KUEUE_TPU_HEAD_PACK") != "0"


def compressible_cqs(statics) -> np.ndarray:
    """[C] bool: CQ sits in a forest no member of which can preempt.

    Pure function of the pack statics' preemption-policy flags
    (``wcq_lower`` | ``rwc_enabled``), i.e. of the structure
    generation; admitted rows of such forests are never candidate-
    gathered by the kernel and may be aggregate-compressed."""
    forest_of_cq = statics.forest_of_cq
    G = len(statics.deep)
    preempting = np.zeros(G, dtype=bool)
    np.logical_or.at(preempting, forest_of_cq,
                     statics.wcq_lower | statics.rwc_enabled)
    return ~preempting[forest_of_cq]


def agg_clear_cq(views: dict, ci: int) -> None:
    for name, (pad, _) in AGG_PLANES.items():
        views[name][ci] = pad


def agg_write_cq(views: dict, ci: int, rec) -> None:
    """Refresh one CQ's aggregate lane from a freshly walked record."""
    views["agg_heads"][ci] = rec.n_pend
    views["agg_rows"][ci] = rec.n_rows
    views["agg_comp"][ci] = rec.n_comp
    views["agg_comp_ts"][ci] = (rec.comp_max_ts
                                if np.isfinite(rec.comp_max_ts) else -1.0)
    if rec.n_pend:
        np_ = rec.n_pend
        best = np.lexsort((rec.keys[:np_], rec.ts[:np_],
                           -rec.prio[:np_]))[0]
        views["agg_best_prio"][ci] = np.clip(
            rec.prio[best], -(2 ** 31 - 1), 2 ** 31 - 1)
        views["agg_best_ts"][ci] = rec.ts[best]
    else:
        views["agg_best_prio"][ci] = 0
        views["agg_best_ts"][ci] = -1.0


def agg_fill(views: dict, records) -> None:
    for ci, rec in enumerate(records):
        agg_write_cq(views, ci, rec)


def agg_summary(state, comp_cq) -> dict:
    """Counters for the driver stats block / kueue_agg_* metrics."""
    return {
        "agg_rows_compressed": int(state.n_comp_cq.sum()),
        "agg_rows_packed": int(state.n_rows_cq.sum()),
        "agg_heads": int(state.n_pend_cq.sum()),
        "agg_cqs_compressible": int(np.count_nonzero(comp_cq)),
    }
