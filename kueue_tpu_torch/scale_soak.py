"""Scale soak of the port: the streaming delta-pack scaling law, the
head-packed 1M-active-CQ ceiling, and the parallel host apply/pack plane,
on the torch device (the JAX package's ``scripts/scale_soak.py``, every
flag, phase and JSON key kept).

  curve     — per-universe-size host pack cost for the streaming arena
              vs a from-scratch rebuild measured on the SAME live state
              at the SAME boundary, byte-level plane parity, bytes to
              the device, and an apply-dominated end-to-end burst A/B
              across four arms (stream, rebuild, nobulk, classic) whose
              decisions must be bit-identical at every size;
  ceiling   — a universe of >= 1M active CQs whose head-packed budget
              rows stay under the kernel's 2^19 composite-key budget
              while the row-backed pack of the same state is over it,
              with one completed admission round at that size;
  head_pack — the budget accounting at the ceiling;
  host_pool — pooled vs serial host apply+pack with the sharded fsync'd
              WAL, decision parity, the cores-vs-throughput curve of the
              pooled WAL-commit plane and ``cores_available``;
  aggregate — packed vs live rows per size, compression on vs off;
  heap      — lazy vs eager heap repair, and the driver-level bulk-apply
              A/B;
  wal_shard — sharded vs single-file CycleWAL and replay parity;
  soak      — a high-count streaming run with the group-committed,
              auto-compacting, sharded CycleWAL attached;
  residues  — the residue ledger with its measured evidence and walls;
  parity    — planes and decisions identical at every size.

    python -m kueue_tpu_torch.scale_soak [--sizes 1000,4000,...] [--seed N]
        [--boundaries N] [--rounds N] [--soak-workloads N]
        [--soak-cqs N] [--ceiling-cqs N] [--preempt-cohorts N]
        [--wal-shards K] [--workers N] [--quick] [--out PATH]
        [--torch-device cuda|cpu]

Every Driver runs on ``--torch-device`` (default ``cuda``: the CUDA
kernels; ``cpu``: their plain versions); without a GPU and without
``--torch-device cpu`` the run raises.  The WAL files live in a
temporary directory removed at the end.  Prints progress on stderr and
the JSON tail as the last line of stdout (also written to ``--out``).
"""

from __future__ import annotations

import argparse
import gc
import glob
import json
import os
import random
import sys
import tempfile
import time
from contextlib import contextmanager

import numpy as np

from . import scenarios
from .api import types as api_types
from .controller.driver import Driver
from .features import env_value
from .northstar import mesh_info
from .obs import trace as _trace
from .ops.burst import pack_burst, pack_burst_cached
from .ops.packing import TightenState, tighten_arrays
from .ops.solver import resolve_device
from .perf.harness import ab_block
from .scenarios import VirtualClock, log
from .scenarios import soak_workload as mk
from .utils.heap import Heap
from .utils.journal import (
    CycleWAL,
    ShardedCycleWAL,
    load_cycle_wal,
    make_cycle_wal,
)
from .utils.parallel_host import POOL_STATS, HostPool

#: the kernel's composite-key row budget (ops/burst.py: uid rank packs
#: into 19 bits) — the ceiling this artifact is about
ROW_BUDGET = 1 << 19

_AGG_FLAG = "KUEUE_TPU_AGG_PLANES"
_HEAD_FLAG = "KUEUE_TPU_HEAD_PACK"
_POOL_FLAG = "KUEUE_TPU_HOST_WORKERS"


@contextmanager
def agg_planes_off():
    """The row-backed control pack: aggregate compression AND head-only
    packing forced off (every live workload charged a budget row),
    environment restored on exit."""
    old = {k: os.environ.get(k) for k in (_AGG_FLAG, _HEAD_FLAG)}
    os.environ[_AGG_FLAG] = "0"
    os.environ[_HEAD_FLAG] = "0"
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def rss_mb() -> float:
    """Current resident set from /proc (no psutil dependency)."""
    try:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith("VmRSS:"):
                    return round(int(line.split()[1]) / 1024.0, 1)
    except OSError:
        pass
    return -1.0


def build(n_cqs: int, preempt_cohorts: int = 0,
          device="cuda") -> tuple[Driver, VirtualClock]:
    """Cohorts of 4, 4000m cpu nominal, BEST_EFFORT_FIFO — the
    chaos/traffic soak cluster shape scaled out, on a Driver on
    ``device``.  The first ``preempt_cohorts`` cohorts carry a
    reclaim+lower-priority preemption policy: their rows are the
    head-pack BUDGET rows; every other forest's rows ride outside the
    2^19 budget."""
    clock = VirtualClock()
    d = Driver(clock=clock, use_device_solver=True, device=device)
    scenarios.soak_cluster(api_types, d, n_cqs, preempt_cohorts)
    return d, clock


def preload(d, clock, n_cqs: int, seed: int) -> None:
    """Two 2500m workloads per CQ (one fits the 4000m nominal, one
    queues behind it), then one fused cycle to admit the first wave —
    every CQ ends with one admitted + one pending row."""
    rng = random.Random(seed)
    for q in range(n_cqs):
        for j in range(2):
            d.create_workload(mk(f"pre-{q}-{j}", f"lq-{q}", 2500,
                                 prio=rng.choice([0, 10, 20]),
                                 t=float(q * 2 + j)))
    clock.t += 1.0
    d.schedule_burst(1)


def current_structure(d):
    solver = d.scheduler.solver
    st = solver._structure
    if st is None or st.generation != d.cache.structure_generation:
        st = solver._structure_for(d.cache.snapshot(), [])
    return st


def plans_equal(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    for attr in ("C", "M", "L", "G", "n_levels", "KC", "seq_base",
                 "max_res_ts"):
        if getattr(a, attr) != getattr(b, attr):
            return False
    if set(a.arrays) != set(b.arrays):
        return False
    for name in a.arrays:
        x, y = np.asarray(a.arrays[name]), np.asarray(b.arrays[name])
        if x.dtype != y.dtype or x.shape != y.shape \
                or not np.array_equal(x, y):
            return False
    return a.keys == b.keys and a.row_of_key == b.row_of_key


def churn(d, clock, rng, n_cqs: int, n_churn: int, tag: str,
          per_cq: int = 1) -> None:
    """O(activity) mutation batch: ``n_churn`` total arrivals land on
    ``n_churn // per_cq`` sampled CQs (``per_cq`` each), and half the
    sampled CQs also finish their admitted head (which is then deleted,
    the 10M-soak's row-retirement path).  ``per_cq=1`` is the classic
    spread regime; ``per_cq>1`` concentrates decisions per CQ per
    cycle — the regime where the cycle bulk apply's deduped requeue
    wakeups have redundancy to win (one wakeup per touched CQ instead
    of one per decision), mirroring how the lazy heap's win is the
    dedupe."""
    cqs = rng.sample(range(n_cqs),
                     min(max(1, n_churn // per_cq), n_cqs))
    clock.t += 1.0
    i = 0
    for k, q in enumerate(cqs):
        for j in range(per_cq):
            name = f"{tag}-{q}" if per_cq == 1 else f"{tag}-{q}-{j}"
            d.create_workload(mk(name, f"lq-{q}", 2500,
                                 prio=rng.choice([0, 10, 20]),
                                 t=clock.t + i * 1e-3))
            i += 1
        if k % 2 == 0:
            key = f"default/pre-{q}-0"
            wl = d.workloads.get(key)
            if wl is not None and wl.has_quota_reservation \
                    and not wl.is_finished:
                d.finish_workload(key)
                d.delete_workload(key)


# ---------------------------------------------------------------------------
# Phase A: pack scaling law (streaming vs rebuild on the same state)
# ---------------------------------------------------------------------------

def pack_curve_point(n_cqs: int, boundaries: int, n_churn: int,
                     seed: int, device="cuda") -> dict:
    log(f"[pack] cqs={n_cqs}: building cluster ...")
    t0 = time.perf_counter()
    d, clock = build(n_cqs, device=device)
    preload(d, clock, n_cqs, seed)
    log(f"[pack] cqs={n_cqs}: preloaded in "
        f"{time.perf_counter() - t0:.1f}s, rss={rss_mb()}MB")

    rng = random.Random(seed + 1)
    stats: dict = {}
    state = None
    tight = TightenState()
    stream_ms, rebuild_ms = [], []
    planes_identical = True
    bytes_raw = bytes_tight = rows = 0
    for b in range(boundaries):
        churn(d, clock, rng, n_cqs, n_churn, f"ch{b}")
        st = current_structure(d)
        t1 = time.perf_counter()
        plan_s, state, _ = pack_burst_cached(
            st, d.queues, d.cache, d.scheduler, clock,
            state=state, stats=stats)
        t2 = time.perf_counter()
        plan_f = pack_burst(st, d.queues, d.cache, d.scheduler, clock)
        t3 = time.perf_counter()
        if b > 0:   # boundary 0 is the counted cold full pack
            stream_ms.append((t2 - t1) * 1e3)
            rebuild_ms.append((t3 - t2) * 1e3)
        if not plans_equal(plan_s, plan_f):
            planes_identical = False
            log(f"[pack] cqs={n_cqs} boundary {b}: PLANES DIVERGED")
        if plan_s is not None:
            arrays = plan_s.arrays
            bytes_raw = sum(int(np.asarray(v).nbytes)
                            for v in arrays.values())
            bytes_tight = sum(
                int(np.asarray(v).nbytes)
                for v in tighten_arrays(arrays, tight).values())
            rows = sum(1 for row in plan_s.keys
                       for k in row if k is not None)
    # the row-backed control pack on the SAME final state: aggregate
    # compression off, everything else identical — the packed-row
    # shrink and the max_res_ts (clock-anchor) equality come from here
    with agg_planes_off():
        plan_row = pack_burst(st, d.queues, d.cache, d.scheduler, clock)
    rows_row_backed = 0 if plan_row is None else sum(
        1 for row in plan_row.keys for k in row if k is not None)
    agg_max_ts_equal = (
        (plan_s is None) == (plan_row is None)
        and (plan_s is None or plan_s.max_res_ts == plan_row.max_res_ts))
    out = {
        "cqs": n_cqs,
        "rows": rows,
        "live_rows": len(d.workloads),
        "rows_row_backed": rows_row_backed,
        "agg_rows_compressed": int(stats.get("agg_rows_compressed", 0)),
        "agg_max_res_ts_equal": bool(agg_max_ts_equal),
        "boundaries": boundaries,
        "churn_cqs_per_boundary": n_churn,
        "pack_ms_stream": round(float(np.median(stream_ms)), 3),
        "pack_ms_rebuild": round(float(np.median(rebuild_ms)), 3),
        "pack_speedup": round(float(np.median(rebuild_ms))
                              / max(float(np.median(stream_ms)), 1e-9),
                              2),
        "planes_identical": planes_identical,
        "bytes_to_device_raw": bytes_raw,
        "bytes_to_device": bytes_tight,
        "tighten_ratio": round(bytes_raw / max(bytes_tight, 1), 2),
        "stream_packs": stats.get("stream_packs", 0),
        "stream_full_packs": stats.get("stream_full_packs", 0),
        "pack_rank_patches": stats.get("pack_rank_patches", 0),
        "arena_bytes": stats.get("pack_arena_bytes", 0),
        "rss_mb": rss_mb(),
    }
    log(f"[pack] cqs={n_cqs}: stream={out['pack_ms_stream']}ms "
        f"rebuild={out['pack_ms_rebuild']}ms "
        f"speedup={out['pack_speedup']}x "
        f"parity={'OK' if planes_identical else 'DIVERGED'}")
    del d
    gc.collect()
    return out


# ---------------------------------------------------------------------------
# Phase B: end-to-end decision A/B (streaming vs rebuild drivers)
# ---------------------------------------------------------------------------

_ARM_ENV = {
    # every scale optimization on: head-only packing (default), aggregate
    # compression, lazy heap, bulk apply, pooled host plane
    "stream": {"KUEUE_TPU_STREAM_PACK": "1",
               "KUEUE_TPU_HOST_WORKERS": "4"},
    "rebuild": {"KUEUE_TPU_STREAM_PACK": "0",
                "KUEUE_BURST_DELTA_PACK": "0"},
    # the single-flag bulk-apply A/B: identical to "stream" except the
    # one-settle cycle bulk apply is off — the honest denominator for
    # the e2e bulk-apply speedup (classic also flips aggregate
    # compression, whose per-admission fold cost lands in the apply
    # path and would confound the measurement)
    "nobulk": {"KUEUE_TPU_STREAM_PACK": "1",
               "KUEUE_TPU_HOST_WORKERS": "4",
               "KUEUE_TPU_CYCLE_BULK_APPLY": "0"},
    # the bit-identity control: streaming pack on, every scale
    # optimization off — head-only packing, aggregate compression,
    # lazy heap repair, one-settle cycle bulk apply, worker pool.
    # This is the full row-backed serial arm of the head-pack parity
    # claim.
    "classic": {"KUEUE_TPU_STREAM_PACK": "1",
                "KUEUE_TPU_AGG_PLANES": "0",
                "KUEUE_TPU_HEAD_PACK": "0",
                "KUEUE_TPU_LAZY_HEAP": "0",
                "KUEUE_TPU_CYCLE_BULK_APPLY": "0",
                "KUEUE_TPU_HOST_WORKERS": "0"},
}

_ARM_KEYS = ("KUEUE_TPU_STREAM_PACK", "KUEUE_BURST_DELTA_PACK",
             "KUEUE_TPU_AGG_PLANES", "KUEUE_TPU_HEAD_PACK",
             "KUEUE_TPU_LAZY_HEAP", "KUEUE_TPU_CYCLE_BULK_APPLY",
             "KUEUE_TPU_HOST_WORKERS")

#: span phases that are pack or device work — everything else inside
#: the timed wall is host decide+apply+heap+queue cost
_KERNEL_SPANS = ("burst.pack", "burst.dispatch", "burst.fetch")


def _span_totals(tracer) -> dict:
    return {n: tracer._hist_for(n).total for n in _KERNEL_SPANS}


def e2e_arm(arm: str, n_cqs: int, rounds: int, n_churn: int,
            seed: int, per_cq: int = 1, device="cuda") -> dict:
    old = {k: os.environ.get(k) for k in _ARM_KEYS}
    for k in _ARM_KEYS:
        os.environ.pop(k, None)
    os.environ.update(_ARM_ENV[arm])
    try:
        d, clock = build(n_cqs, device=device)
        preload(d, clock, n_cqs, seed)
        # span tracing is decision-neutral (OBS artifact contract) and
        # is enabled on every arm alike; the pack/dispatch/fetch span
        # sums subtracted from the timed wall leave the per-cycle HOST
        # apply+heap+queue cost the bulk-apply stack targets
        tracer = d.obs.enable_tracing()
        rng = random.Random(seed + 2)
        decisions = []
        n_cycles = 0
        wall = 0.0
        # GC fairness: the cycle collector is 100-200ms/cycle of pure
        # threshold-timing luck inside the timed window (whichever arm
        # crosses a gen2 threshold first eats a full-heap scan —
        # measured 0.46x-1.2x swings on the SAME arm pair), and
        # refcounting frees non-cyclic garbage immediately anyway, so
        # every arm runs its timed rounds with the collector off
        gc.collect()
        gc.disable()
        base_spans = _span_totals(tracer)
        # round 0 is an untimed warmup: it absorbs the fused kernel's
        # JIT compiles (shape-dependent, cached process-wide) so the
        # timed rounds measure steady state — its DECISIONS still count
        # toward the parity check
        for r in range(rounds + 1):
            churn(d, clock, rng, n_cqs, n_churn, f"e2e{r}",
                  per_cq=per_cq)
            t0 = time.perf_counter()
            recs = d.schedule_burst(
                3, runtime=2,
                on_cycle_start=lambda k: setattr(clock, "t",
                                                 clock.t + 1.0))
            if r > 0:
                wall += time.perf_counter() - t0
                n_cycles += len(recs)
            else:
                base_spans = _span_totals(tracer)
            decisions.extend(
                (sorted(s.admitted), sorted(s.skipped),
                 sorted(s.preempted_targets)) for s in recs)
        spans = _span_totals(tracer)
        kernel_s = sum(spans[n] - base_spans[n] for n in _KERNEL_SPANS)
        host_apply_ms = round(
            max(wall - kernel_s, 0.0) * 1e3 / max(n_cycles, 1), 3)
        bs = dict(d._burst_solver.stats) if d._burst_solver else {}
        pack_block = d.stats.get("pack", {})
    finally:
        gc.enable()
        _trace.clear()
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    del d
    gc.collect()
    return {"arm": arm, "decisions": decisions,
            "cycle_wall_ms": round(wall * 1e3 / max(n_cycles, 1), 2),
            "host_apply_ms": host_apply_ms,
            "n_cycles": n_cycles,
            "bytes_h2d": int(bs.get("burst_launch_bytes_h2d", 0)),
            "pack": pack_block}


# ---------------------------------------------------------------------------
# Phase B2: the lifted row ceiling + the host apply/WAL microbenches
# ---------------------------------------------------------------------------

def ceiling_probe(n_cqs: int, preempt_cohorts: int, seed: int,
                  device="cuda") -> dict:
    """The row wall broken on one state: >= 1M ACTIVE CQs (every one
    holding pending work after the preload's completed admission round)
    whose head-packed BUDGET rows — rows of the ``preempt_cohorts``
    forests that can preempt — stay far under the kernel's 2^19
    composite-key budget, while the row-backed pack of the SAME state
    charges every live workload a row and lands ~4x over it.  One
    soak-style round (one arrival per CQ, fused cycles, retirement)
    measures the honest per-round wall at this size.

    The preload admits one wave in a single burst round, so admitted
    reservations share their timestamps — the seq gate (dense rank
    over DISTINCT admitted timestamps) stays global and tiny here;
    a universe with >= 2^20 distinct admitted timestamps remains a
    wall and is ledgered below."""
    log(f"[ceiling] cqs={n_cqs} (preempting cohorts="
        f"{preempt_cohorts}): building ...")
    t0 = time.perf_counter()
    d, clock = build(n_cqs, preempt_cohorts=preempt_cohorts, device=device)
    preload(d, clock, n_cqs, seed)
    build_s = time.perf_counter() - t0
    log(f"[ceiling] cqs={n_cqs}: built and preloaded in {build_s:.1f}s, "
        f"rss={rss_mb()}MB")
    live_rows = len(d.workloads)
    active_pending = sum(
        1 for name in d.queues.cluster_queue_names()
        if d.queues.pending_workloads(name))
    st = current_structure(d)
    t1 = time.perf_counter()
    plan = pack_burst(st, d.queues, d.cache, d.scheduler, clock)
    pack_agg_s = time.perf_counter() - t1
    rows_grid = 0 if plan is None else sum(
        1 for row in plan.keys for k in row if k is not None)
    # the quantity the 2^19 budget binds: rows charged to
    # the composite-key uid rank + poison gates (preempting forests)
    rows_budget = 0 if plan is None else int(plan.budget_rows)
    with agg_planes_off():
        t2 = time.perf_counter()
        plan_row = pack_burst(st, d.queues, d.cache, d.scheduler, clock)
        pack_row_s = time.perf_counter() - t2
    rows_row_backed = 0 if plan_row is None else sum(
        1 for row in plan_row.keys for k in row if k is not None)
    row_backed_budget = 0 if plan_row is None \
        else int(plan_row.budget_rows)
    del plan, plan_row
    gc.collect()
    log(f"[ceiling] cqs={n_cqs}: packs {pack_agg_s:.1f}s (head-packed), "
        f"{pack_row_s:.1f}s (row-backed); the round ...")
    # one soak-style round at the ceiling: the per-round wall that
    # sizes any longer soak at this universe
    clock.t += 1.0
    t3 = time.perf_counter()
    for i in range(n_cqs):
        d.create_workload(mk(f"ceil-{i}", f"lq-{i}", 2500,
                             prio=(i % 3) * 10, t=clock.t + i * 1e-4))
    recs = d.schedule_burst(
        4, runtime=2,
        on_cycle_start=lambda k: setattr(clock, "t", clock.t + 1.0))
    admitted = sum(len(s.admitted) for s in recs)
    done = [k for k, w in d.workloads.items() if w.is_finished]
    for k in done:
        d.delete_workload(k)
    round_s = time.perf_counter() - t3
    out = {
        "cqs": n_cqs,
        "active_cqs_pending": active_pending,
        "preempt_cohorts": preempt_cohorts,
        "row_budget": ROW_BUDGET,
        "live_rows": live_rows,
        "rows_packed": rows_budget,
        "rows_grid": rows_grid,
        "rows_row_backed": rows_row_backed,
        "rows_budget_row_backed": row_backed_budget,
        "packed_under_budget": rows_budget < ROW_BUDGET,
        "row_backed_over_budget": rows_row_backed >= ROW_BUDGET,
        "pack_ms_agg": round(pack_agg_s * 1e3, 1),
        "pack_ms_row_backed": round(pack_row_s * 1e3, 1),
        "build_s": round(build_s, 1),
        "round": {"arrivals": n_cqs, "admitted": admitted,
                  "retired": len(done), "wall_s": round(round_s, 1)},
        "rss_mb": rss_mb(),
    }
    log(f"[ceiling] cqs={n_cqs}: active_pending={active_pending} "
        f"live={live_rows} budget_rows={rows_budget} "
        f"grid={rows_grid} row_backed={rows_row_backed} "
        f"(budget {ROW_BUDGET}), round={out['round']['wall_s']}s, "
        f"rss={rss_mb()}MB")
    del d
    gc.collect()
    return out


def host_pool_arm(workers: int, n_cqs: int, rounds: int, seed: int,
                  wal_path: str, device="cuda") -> dict:
    """One arm of the parallel-host-plane A/B: the apply-dominated
    regime (one arrival per CQ per round, half the preloaded heads
    finishing) with the sharded fsync'd WAL attached, every other scale
    optimization on.  Returns the per-cycle apply+pack host wall (the
    timed cycle wall minus the pack/dispatch/fetch spans) and the full
    decision trace for the bit-identity check."""
    old = {k: os.environ.get(k) for k in (_POOL_FLAG,)}
    os.environ[_POOL_FLAG] = str(workers)
    for p in glob.glob(wal_path + "*"):
        os.remove(p)
    base_pool = dict(POOL_STATS)
    try:
        d, clock = build(n_cqs, device=device)
        preload(d, clock, n_cqs, seed)
        wal = ShardedCycleWAL(wal_path, shards=4, commit_every=1,
                              fsync=True)
        d.attach_wal(wal)
        tracer = d.obs.enable_tracing()
        rng = random.Random(seed + 5)
        decisions = []
        n_cycles = 0
        wall = 0.0
        gc.collect()   # same GC discipline as e2e_arm: collector off
        gc.disable()   # inside the timed window (threshold-timing luck)
        base_spans = _span_totals(tracer)
        for r in range(rounds + 1):   # round 0: untimed JIT warmup
            churn(d, clock, rng, n_cqs, n_cqs, f"hp{r}", per_cq=4)
            t0 = time.perf_counter()
            recs = d.schedule_burst(
                3, runtime=2,
                on_cycle_start=lambda k: setattr(clock, "t",
                                                 clock.t + 1.0))
            if r > 0:
                wall += time.perf_counter() - t0
                n_cycles += len(recs)
            else:
                base_spans = _span_totals(tracer)
            decisions.extend(
                (sorted(s.admitted), sorted(s.skipped),
                 sorted(s.preempted_targets)) for s in recs)
        spans = _span_totals(tracer)
        kernel_s = sum(spans[n] - base_spans[n] for n in _KERNEL_SPANS)
        wal_stats = dict(wal.stats)
        wal.close()
    finally:
        gc.enable()
        _trace.clear()
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        for p in glob.glob(wal_path + "*"):
            os.remove(p)
    pool_stats = {k: POOL_STATS[k] - base_pool[k] for k in POOL_STATS}
    del d
    gc.collect()
    return {
        "workers": workers,
        "decisions": decisions,
        "n_cycles": n_cycles,
        "cycle_wall_ms": round(wall * 1e3 / max(n_cycles, 1), 2),
        "apply_pack_ms": round(
            max(wall - kernel_s, 0.0) * 1e3 / max(n_cycles, 1), 3),
        "pool_stats": pool_stats,
        "wal_appenders": wal_stats.get("wal_appenders", 0),
        "wal_commits": wal_stats.get("wal_commits", 0),
    }


def pool_plane_curve(prefix: str, n_ops: int, shards: int,
                     workers_list: list[int],
                     commit_every_ops: int = 8) -> list[dict]:
    """Cores-vs-throughput curve of the pooled WAL-commit plane: the
    same fsync'd decision stream driven through the sharded WAL with
    K pool workers fanning the per-segment group commits.  The commit
    flush+fsync releases the GIL, so this is the component of the
    apply/pack plane that genuinely overlaps on any core count.  Two
    bench appenders hold the stripe layout CONSTANT across worker
    counts — without them the workers=1 point would auto-collapse to
    one segment and the curve would measure segment count, not
    overlap; at workers=1 the pool is inline, so that point is the
    serial per-segment commit loop over the identical layout."""
    points = []
    for w in workers_list:
        path = f"{prefix}.w{w}"
        for p in glob.glob(path + "*"):
            os.remove(p)
        wal = ShardedCycleWAL(path, shards=shards, commit_every=1,
                              fsync=True)
        wal.register_appender("bench-a")
        wal.register_appender("bench-b")
        pool = HostPool(w)
        pool.attach_wal(wal)
        t0 = time.perf_counter()
        for i in range(n_ops):
            wal.log({"op": "admit", "key": f"ns/w{i}",
                     "cq": f"cq-{i % 257}", "at": float(i)})
            if (i + 1) % commit_every_ops == 0:
                pool.commit_wal(wal)
        pool.commit_wal(wal)
        wall = time.perf_counter() - t0
        seqs = [op.get("seq") for op in
                sorted((o for sh in wal._shards
                        for b in (sh.batches + [sh.tail]) for o in b),
                       key=lambda o: o.get("seq", 0))]
        order_ok = seqs == list(range(len(seqs)))
        pool.detach_wal(wal)
        pool.close()
        wal.close()
        for p in glob.glob(path + "*"):
            os.remove(p)
        points.append({"workers": w,
                       "wall_ms": round(wall * 1e3, 1),
                       "ops_per_s": round(n_ops / max(wall, 1e-9)),
                       "seq_order_ok": bool(order_ok)})
        log(f"[pool] plane workers={w}: {points[-1]['wall_ms']}ms "
            f"({points[-1]['ops_per_s']} ops/s)")
    return points


class HeapItem:
    __slots__ = ("key", "prio", "ts")

    def __init__(self, key, prio, ts):
        self.key = key
        self.prio = prio
        self.ts = ts


def _heap_less(a, b):
    if a.prio != b.prio:
        return a.prio > b.prio
    if a.ts != b.ts:
        return a.ts < b.ts
    return a.key < b.key


def heap_bench(n_items: int, batch: int, cycles: int, seed: int) -> dict:
    """Per-cycle decision-apply cost on the CQ heap, lazy vs eager.

    One burst cycle's apply touches each decided key several times
    (requeue, backoff bump, priority/park update) and only the NEXT
    cycle's head read needs order — the access pattern lazy repair
    amortizes: eager pays a sift per touch, lazy pays a dict write per
    touch and one sift per KEY at the settle.  The same scripted storm
    replays on both arms; drain parity at the end re-proves order
    equality at this size."""
    points = []
    order_parity = True
    for touches in (1, 4, 8):
        rng = random.Random(seed * 7 + touches)
        storms = []
        for _ in range(cycles):
            ops = []
            for _ in range(batch):
                key = f"w{rng.randrange(n_items)}"
                for _ in range(touches):
                    ops.append((key, rng.choice((0, 10, 50)),
                                round(rng.random() * 1e3, 3)))
            storms.append(ops)
        walls = {}
        drains = {}
        for lazy in (False, True):
            h = Heap(key_fn=lambda it: it.key, less=_heap_less,
                     lazy=lazy)
            for i in range(n_items):
                h.push_or_update(HeapItem(f"w{i}", i % 50, float(i)))
            h.peek()   # settle the prefill outside the timed region
            t0 = time.perf_counter()
            for ops in storms:
                for key, prio, ts in ops:
                    h.push_or_update(HeapItem(key, prio, ts))
                # the next cycle's head read + requeue roundtrip
                top = h.pop()
                if top is not None:
                    h.push_or_update(top)
            walls[lazy] = (time.perf_counter() - t0) * 1e3 / cycles
            seq = []
            while (it := h.pop()) is not None:
                seq.append(it.key)
            drains[lazy] = seq
        if drains[False] != drains[True]:
            order_parity = False
        points.append({
            "touches_per_key": touches,
            "eager_ms_per_cycle": round(walls[False], 3),
            "lazy_ms_per_cycle": round(walls[True], 3),
            "speedup": round(walls[False] / max(walls[True], 1e-9), 2),
        })
        log(f"[heap] items={n_items} touches={touches}: "
            f"eager={points[-1]['eager_ms_per_cycle']}ms "
            f"lazy={points[-1]['lazy_ms_per_cycle']}ms "
            f"({points[-1]['speedup']}x)")
    return {"items": n_items, "batch": batch, "cycles": cycles,
            "order_parity": order_parity, "points": points}


def wal_shard_bench(prefix: str, n_ops: int, shards: int,
                    commit_every: int) -> dict:
    """Append + group-commit wall for one high-rate decision stream,
    single-file vs sharded, and replay parity: the sharded tail merged
    back into seq order must equal the unsharded tail op for op (seq
    stamps aside), live and after a file round-trip.

    The sharded WAL with no registered appenders auto-
    collapses to one hot segment — the default ``sharded_ms`` arm
    measures that single-writer path (the fix for the 0.84x
    regression); ``striped_ms`` re-registers two appenders to engage
    the striping the concurrent host plane uses."""
    def drive(w, reps: int = 1):
        """Best-of-``reps`` appends of the same stream (the box is a
        shared single core; one GC pause or disk stall skews a single
        pass by 20%+).  Only the last pass leaves the tail behind."""
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            for i in range(n_ops):
                w.log({"op": "admit", "key": f"ns/w{i}",
                       "cq": f"cq-{i % 257}", "at": float(i)})
                if (i + 1) % 32 == 0:
                    w.commit()
            best = min(best, (time.perf_counter() - t0) * 1e3)
        for i in range(5):   # the open tail a crash would replay
            w.log({"op": "evict", "key": f"ns/w{i}", "at": float(i)})
        return best

    p1, pk = prefix + ".one", prefix + ".striped"
    for p in glob.glob(p1 + "*") + glob.glob(pk + "*"):
        os.remove(p)
    w1 = CycleWAL(p1, commit_every=commit_every)
    ms1 = drive(w1, reps=2)
    wk = ShardedCycleWAL(pk, shards=shards, commit_every=commit_every)
    msk = drive(wk, reps=2)   # no appenders: collapsed single-writer path
    ws = ShardedCycleWAL(pk + ".eng", shards=shards,
                         commit_every=commit_every)
    ws.register_appender("bench-a")
    ws.register_appender("bench-b")
    mss = drive(ws, reps=2)   # two appenders: striping engaged
    striped_segments = sum(
        1 for sh in ws._shards
        if sh.tail or any(sh.batches))
    collapsed_segments = sum(
        1 for sh in wk._shards
        if sh.tail or any(sh.batches))
    ws.close()
    for p in glob.glob(pk + ".eng*"):
        os.remove(p)

    def strip(ops):
        return [{k: v for k, v in op.items() if k != "seq"}
                for op in ops]

    tails_equal = strip(wk.tail) == list(w1.tail)
    committed1 = sum(len(b) for b in w1.batches)
    committedk = sum(len(b) for sh in wk._shards for b in sh.batches)
    skew = wk.stats["wal_shard_skew"]
    w1.close()
    wk.close()
    l1, lk = load_cycle_wal(p1), load_cycle_wal(pk)
    roundtrip = (isinstance(lk, ShardedCycleWAL)
                 and strip(lk.tail) == list(l1.tail)
                 and strip(lk.tail) == strip(wk.tail))
    for p in glob.glob(p1 + "*") + glob.glob(pk + "*"):
        os.remove(p)
    out = {
        "ops": n_ops,
        "shards": shards,
        "commit_every": commit_every,
        "single_ms": round(ms1, 1),
        "sharded_ms": round(msk, 1),
        "striped_ms": round(mss, 1),
        "single_ops_per_s": round(n_ops / max(ms1 / 1e3, 1e-9)),
        "sharded_ops_per_s": round(n_ops / max(msk / 1e3, 1e-9)),
        "commit_speedup": round(ms1 / max(msk, 1e-9), 2),
        "collapsed_segments": collapsed_segments,
        "striped_segments": striped_segments,
        "shard_skew": skew,
        "replay_parity": bool(tails_equal and roundtrip
                              and committed1 == committedk),
    }
    log(f"[wal] {n_ops} ops: single={out['single_ms']}ms "
        f"sharded-collapsed({shards})={out['sharded_ms']}ms "
        f"striped={out['striped_ms']}ms "
        f"(segments {collapsed_segments}/{striped_segments}) "
        f"parity={'OK' if out['replay_parity'] else 'DIVERGED'}")
    return out


# ---------------------------------------------------------------------------
# Phase C: the high-count workload soak
# ---------------------------------------------------------------------------

def soak(n_cqs: int, target: int, seed: int, wal_path: str,
         commit_every: int, wal_shards: int = 1, device="cuda") -> dict:
    log(f"[soak] cqs={n_cqs} target={target} workloads, "
        f"wal commit_every={commit_every} shards={wal_shards} ...")
    t0 = time.perf_counter()
    d, clock = build(n_cqs, device=device)
    wal = make_cycle_wal(wal_path, commit_every=commit_every,
                         compact_every=64, shards=wal_shards)
    d.attach_wal(wal)
    rng = random.Random(seed + 3)
    created = finished = admitted = 0
    rounds = 0
    prios = [0, 10, 20]
    peak_rss = rss_mb()
    t_report = t0
    while created < target:
        batch = min(n_cqs, target - created)
        clock.t += 1.0
        for i in range(batch):
            q = i % n_cqs
            d.create_workload(mk(f"s{rounds}-{i}", f"lq-{q}", 2500,
                                 prio=prios[(rounds + i) % 3],
                                 t=clock.t + i * 1e-4))
        created += batch
        recs = d.schedule_burst(
            4, runtime=2,
            on_cycle_start=lambda k: setattr(clock, "t",
                                             clock.t + 1.0))
        for s in recs:
            admitted += len(s.admitted)
        # retire finished rows so the live store stays O(active)
        done = [k for k, w in d.workloads.items() if w.is_finished]
        for k in done:
            d.delete_workload(k)
        finished += len(done)
        rounds += 1
        peak_rss = max(peak_rss, rss_mb())
        now = time.perf_counter()
        if now - t_report > 30.0:
            t_report = now
            log(f"[soak] {created}/{target} created, "
                f"{admitted} admitted, {finished} retired, "
                f"round {rounds}, rss={rss_mb()}MB, "
                f"{now - t0:.0f}s")
    # drain the in-flight tail
    for _ in range(4):
        recs = d.schedule_burst(
            4, runtime=2,
            on_cycle_start=lambda k: setattr(clock, "t",
                                             clock.t + 1.0))
        for s in recs:
            admitted += len(s.admitted)
        done = [k for k, w in d.workloads.items() if w.is_finished]
        for k in done:
            d.delete_workload(k)
        finished += len(done)
    wal_stats = dict(wal.stats)
    wal.close()
    # single-file layout is wal_path itself; sharded is wal_path.sNN
    wal_size = sum(os.path.getsize(p)
                   for p in glob.glob(wal_path + "*"))
    pack_block = d.stats.get("pack", {})
    wall = time.perf_counter() - t0
    out = {
        "cqs": n_cqs,
        "target_workloads": target,
        "created": created,
        "admitted": admitted,
        "finished": finished,
        "rounds": rounds,
        "completed": created >= target,
        "wall_s": round(wall, 1),
        "workloads_per_s": round(created / max(wall, 1e-9), 1),
        "peak_rss_mb": peak_rss,
        "wal": {**wal_stats,
                "commit_every": commit_every,
                "compact_every": 64,
                "layout": "sharded" if wal_shards > 1 else "single",
                "final_file_bytes": wal_size},
        "pack_counters": pack_block,
    }
    log(f"[soak] done: {created} workloads in {out['wall_s']}s "
        f"({out['workloads_per_s']}/s), {admitted} admitted, "
        f"wal compactions={wal_stats.get('wal_compactions', 0)} "
        f"file={wal_size}B")
    del d
    gc.collect()
    return out


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", default="",
                    help="comma-separated CQ universe sizes")
    ap.add_argument("--seed", type=int,
                    default=int(env_value("KUEUE_TPU_SCALE_SEED")))
    ap.add_argument("--boundaries", type=int, default=8,
                    help="measured pack boundaries per size")
    ap.add_argument("--rounds", type=int, default=3,
                    help="churn+burst rounds per end-to-end arm")
    ap.add_argument("--churn", type=int, default=64,
                    help="CQs churned per boundary (the 'activity')")
    ap.add_argument("--soak-workloads", type=int, default=0,
                    help="0 = 10M full / 100k quick")
    ap.add_argument("--soak-cqs", type=int, default=0,
                    help="soak universe size (0 = largest curve size)")
    ap.add_argument("--ceiling-cqs", type=int, default=0,
                    help="row-ceiling probe size (0 = 1,052,672 full "
                         "/ 2x the largest curve size quick)")
    ap.add_argument("--preempt-cohorts", type=int, default=0,
                    help="preempting (budget-row) cohorts in the "
                         "ceiling probe (0 = 1024 full / 8 quick)")
    ap.add_argument("--wal-shards", type=int, default=4,
                    help="CycleWAL segments for the soak (1 = the "
                         "classic single file)")
    ap.add_argument("--workers", type=int, default=4,
                    help="pooled arm worker count for the host-plane "
                         "A/B (serial control is always workers=0)")
    ap.add_argument("--pool-cqs", type=int, default=0,
                    help="host-plane A/B universe size (0 = largest "
                         "curve size)")
    ap.add_argument("--pool-rounds", type=int, default=2,
                    help="timed apply-dominated rounds per pool arm")
    ap.add_argument("--quick", action="store_true",
                    help="8k-CQ ceiling + 100k-workload soak")
    ap.add_argument("--out", default=None,
                    help="also write the JSON tail to this file")
    ap.add_argument("--torch-device", default="cuda",
                    help="the torch device of the Drivers (cuda: the CUDA "
                         "kernels; cpu: their plain versions)")
    return ap


def run(args, record: dict | None = None) -> tuple[dict, bool]:
    """Every phase at the sizes the flags give → (the JSON tail, whether
    every parity gate held).  ``record``, when given, receives the
    digest (``scenarios.records_digest``) of each end-to-end arm's
    decisions by ``(cqs, arm)``, and of each host-pool arm's by
    ``("pool", workers)``."""
    dev = resolve_device(args.torch_device)
    with tempfile.TemporaryDirectory(prefix="scale_soak_") as td:
        return _run(args, dev, os.path.join(td, "scale"), record)


def _run(args, dev, base: str, record) -> tuple[dict, bool]:
    if args.sizes:
        sizes = [int(s) for s in args.sizes.split(",") if s]
    elif args.quick:
        sizes = [1000, 4000]
    else:
        sizes = [1000, 4000, 10000, 30000, 100000]
    boundaries = 4 if args.quick else args.boundaries
    soak_target = args.soak_workloads or (100_000 if args.quick
                                          else 2_000_000)
    soak_cqs = args.soak_cqs or sizes[-1]
    # full: 263,168 cohorts of 4 = 1,052,672 CQs — past the 1M-active
    # mark with every CQ holding pending work; 1,024 of the cohorts
    # preempt, so the head-packed budget rows stay ~8k under the 2^19
    # budget while live rows run ~2.1M
    ceiling_cqs = args.ceiling_cqs or (
        2 * sizes[-1] if args.quick else 1_052_672)
    preempt_cohorts = args.preempt_cohorts or (8 if args.quick
                                               else 1024)
    pool_cqs = args.pool_cqs or sizes[-1]
    commit_every = int(env_value("KUEUE_TPU_WAL_COMMIT_EVERY", "64"))
    t_start = time.perf_counter()
    log(f"scale soak: sizes={sizes} boundaries={boundaries} "
        f"churn={args.churn} soak={soak_target}@{soak_cqs}cqs "
        f"ceiling={ceiling_cqs}cqs(+{preempt_cohorts} preempting "
        f"cohorts) pool={args.workers}w@{pool_cqs}cqs "
        f"wal_shards={args.wal_shards} seed={args.seed}")

    curve = []
    for n in sizes:
        point = pack_curve_point(n, boundaries, args.churn, args.seed,
                                 device=dev)
        # end-to-end A/B in the APPLY-DOMINATED regime (one arrival
        # per CQ per round, so admissions/cycle scale with the
        # universe); rebuild and classic interleaved right after
        # streaming on the same box (the environment-drift control)
        # apply-dominated regime: n total arrivals per round,
        # concentrated 4 per CQ on a quarter of the CQs, so each cycle
        # carries several decisions per touched CQ — the redundancy the
        # one-settle bulk apply dedupes (spread 1-per-CQ churn is its
        # dedupe-free worst case, measured ~1.0x in r18)
        e_s, e_r, e_n, e_c = (
            e2e_arm(arm, n, args.rounds, n, args.seed, per_cq=4,
                    device=dev)
            for arm in ("stream", "rebuild", "nobulk", "classic"))
        if record is not None:
            for e in (e_s, e_r, e_n, e_c):
                record[(n, e["arm"])] = scenarios.records_digest(
                    e["decisions"])
        point["decisions_identical"] = \
            e_s["decisions"] == e_r["decisions"]
        point["decisions_identical_nobulk"] = \
            e_s["decisions"] == e_n["decisions"]
        point["decisions_identical_classic"] = \
            e_s["decisions"] == e_c["decisions"]
        point["cycle_wall_ms"] = e_s["cycle_wall_ms"]
        point["cycle_wall_ms_rebuild"] = e_r["cycle_wall_ms"]
        point["cycle_wall_ms_classic"] = e_c["cycle_wall_ms"]
        point["host_apply_ms"] = e_s["host_apply_ms"]
        point["host_apply_ms_nobulk"] = e_n["host_apply_ms"]
        point["host_apply_ms_classic"] = e_c["host_apply_ms"]
        # the e2e bulk-apply speedup: single-flag A/B (stream vs the
        # same arm with KUEUE_TPU_CYCLE_BULK_APPLY=0); classic is kept
        # as the everything-off reference — it also drops aggregate
        # compression, whose per-admission fold cost sits in apply, so
        # classic/stream under-reports the bulk win by that tax
        point["host_apply_speedup"] = round(
            e_n["host_apply_ms"] / max(e_s["host_apply_ms"], 1e-3), 2)
        point["host_apply_speedup_vs_classic"] = round(
            e_c["host_apply_ms"] / max(e_s["host_apply_ms"], 1e-3), 2)
        point["bytes_h2d_e2e"] = e_s["bytes_h2d"]
        point["e2e_cycles"] = e_s["n_cycles"]
        point["pack_counters"] = e_s["pack"]
        point["pack_counters_rebuild"] = e_r["pack"]
        log(f"[e2e] cqs={n}: cycle={e_s['cycle_wall_ms']}ms "
            f"(rebuild {e_r['cycle_wall_ms']}ms, classic "
            f"{e_c['cycle_wall_ms']}ms) host apply "
            f"{e_s['host_apply_ms']}ms vs {e_n['host_apply_ms']}ms "
            f"bulk-off ({point['host_apply_speedup']}x, classic "
            f"{e_c['host_apply_ms']}ms), decisions "
            f"{'identical' if point['decisions_identical'] and point['decisions_identical_nobulk'] and point['decisions_identical_classic'] else 'DIVERGED'}")
        curve.append(point)

    ceiling = ceiling_probe(ceiling_cqs, preempt_cohorts, args.seed,
                            device=dev)

    # the parallel host apply/pack plane A/B: serial control first,
    # pooled arm interleaved right after on the same box
    hp_serial, hp_pooled = (
        host_pool_arm(w, pool_cqs, args.pool_rounds, args.seed,
                      base + ".poolwal", device=dev)
        for w in (0, args.workers))
    if record is not None:
        for hp in (hp_serial, hp_pooled):
            record[("pool", hp["workers"])] = scenarios.records_digest(
                hp["decisions"])
    pool_curve = pool_plane_curve(
        base + ".planewal",
        n_ops=2_000 if args.quick else 20_000,
        shards=max(4, args.wal_shards),
        workers_list=[1, 2, args.workers, 2 * args.workers])
    host_pool = {
        "flag": "KUEUE_TPU_HOST_WORKERS",
        "cqs": pool_cqs,
        "workers": args.workers,
        "cores_available": os.cpu_count() or 1,
        "apply_pack_ms_serial": hp_serial["apply_pack_ms"],
        "apply_pack_ms_pooled": hp_pooled["apply_pack_ms"],
        "apply_pack_speedup": round(
            hp_serial["apply_pack_ms"]
            / max(hp_pooled["apply_pack_ms"], 1e-3), 2),
        "cycle_wall_ms_serial": hp_serial["cycle_wall_ms"],
        "cycle_wall_ms_pooled": hp_pooled["cycle_wall_ms"],
        "decisions_identical":
            hp_serial["decisions"] == hp_pooled["decisions"],
        "pool_stats": hp_pooled["pool_stats"],
        "wal_appenders_pooled": hp_pooled["wal_appenders"],
        "cores_curve": pool_curve,
        "plane_overlap_speedup": round(
            next(p["wall_ms"] for p in pool_curve
                 if p["workers"] == 1)
            / max(next(p["wall_ms"] for p in pool_curve
                       if p["workers"] == args.workers), 1e-9), 2),
    }
    log(f"[pool] cqs={pool_cqs}: apply+pack serial="
        f"{host_pool['apply_pack_ms_serial']}ms pooled="
        f"{host_pool['apply_pack_ms_pooled']}ms "
        f"({host_pool['apply_pack_speedup']}x, plane overlap "
        f"{host_pool['plane_overlap_speedup']}x, cores="
        f"{host_pool['cores_available']}), decisions "
        f"{'identical' if host_pool['decisions_identical'] else 'DIVERGED'}")

    heap_micro = heap_bench(
        n_items=5_000 if args.quick else 100_000,
        batch=256 if args.quick else 4096,
        cycles=5 if args.quick else 10, seed=args.seed)
    wal_block = wal_shard_bench(
        base + ".walbench",
        n_ops=5_000 if args.quick else 200_000,
        shards=max(2, args.wal_shards), commit_every=commit_every)

    wal_path = base + "_wal.jsonl"
    soak_block = soak(soak_cqs, soak_target, args.seed, wal_path,
                      commit_every, wal_shards=args.wal_shards, device=dev)
    for p in glob.glob(wal_path + "*"):
        try:
            os.remove(p)
        except OSError:
            pass

    top = curve[-1]
    parity = {
        "planes_identical_all": all(p["planes_identical"]
                                    for p in curve),
        "decisions_identical_all": all(p["decisions_identical"]
                                       for p in curve),
        "decisions_identical_nobulk_all": all(
            p["decisions_identical_nobulk"] for p in curve),
        "decisions_identical_classic_all": all(
            p["decisions_identical_classic"] for p in curve),
        "max_res_ts_equal_all": all(p["agg_max_res_ts_equal"]
                                    for p in curve),
    }
    drift = ab_block(
        treatment={"arm": "stream", "cqs": top["cqs"],
                   "pack_ms": top["pack_ms_stream"],
                   "cycle_wall_ms": top["cycle_wall_ms"],
                   "pack": top["pack_counters"]},
        control={"arm": "rebuild", "interleaved": True,
                 "cqs": top["cqs"],
                 "pack_ms": top["pack_ms_rebuild"],
                 "cycle_wall_ms": top["cycle_wall_ms_rebuild"],
                 "pack": top["pack_counters_rebuild"]})

    aggregate = {
        "flag": "KUEUE_TPU_AGG_PLANES",
        "row_budget": ROW_BUDGET,
        "points": [{"cqs": p["cqs"], "live_rows": p["live_rows"],
                    "rows_packed": p["rows"],
                    "rows_row_backed": p["rows_row_backed"],
                    "rows_compressed": p["agg_rows_compressed"],
                    "max_res_ts_equal": p["agg_max_res_ts_equal"]}
                   for p in curve],
        "max_res_ts_equal_all": parity["max_res_ts_equal_all"],
        "compression_at_max": round(
            top["rows_row_backed"] / max(top["rows"], 1), 2),
    }
    heap_block = {
        "flag": "KUEUE_TPU_LAZY_HEAP",
        "microbench": heap_micro,
        "driver_host_apply": {
            "cqs": top["cqs"],
            "optimized_ms_per_cycle": top["host_apply_ms"],
            "bulk_off_ms_per_cycle": top["host_apply_ms_nobulk"],
            "classic_ms_per_cycle": top["host_apply_ms_classic"],
            "speedup": top["host_apply_speedup"],
            "speedup_vs_classic": top["host_apply_speedup_vs_classic"],
        },
    }
    heap_t1 = next(p["speedup"] for p in heap_micro["points"]
                   if p["touches_per_key"] == 1)
    heap_t8 = next(p["speedup"] for p in heap_micro["points"]
                   if p["touches_per_key"] == 8)
    soak_rate = soak_block["workloads_per_s"]
    head_pack = {
        "flag": "KUEUE_TPU_HEAD_PACK",
        "row_budget": ROW_BUDGET,
        "ceiling_cqs": ceiling["cqs"],
        "active_cqs_pending": ceiling["active_cqs_pending"],
        "budget_rows": ceiling["rows_packed"],
        "grid_rows": ceiling["rows_grid"],
        "live_rows": ceiling["live_rows"],
        "rows_row_backed": ceiling["rows_row_backed"],
        "budget_utilization": round(
            ceiling["rows_packed"] / ROW_BUDGET, 4),
        "row_backed_over_budget_x": round(
            ceiling["rows_row_backed"] / ROW_BUDGET, 2),
    }
    residues = {
        "baseline": "SCALE_r18",
        "entries": [
            {"id": "pending_head_row_cap",
             "residue": "pending heads stayed row-backed, so the 2^19 "
                        "composite-key budget capped ACTIVE CQs near "
                        "524,288 (r18 probed 500k CQs / 1M live rows)",
             "status": "lifted",
             "flag": "KUEUE_TPU_HEAD_PACK",
             "mechanism": "head-only packing: the uid rank and the "
                          "n/prio poison gates charge only rows of "
                          "forests that can preempt; pending rows of "
                          "never-preempting forests ride outside the "
                          "budget as rank context (their uidrank "
                          "cells are never read — candidate "
                          "eligibility needs the head CQ's "
                          "wcq_lower/rwc_enabled)",
             "evidence": {"cqs": ceiling["cqs"],
                          "active_cqs_pending":
                              ceiling["active_cqs_pending"],
                          "live_rows": ceiling["live_rows"],
                          "budget_rows": ceiling["rows_packed"],
                          "grid_rows": ceiling["rows_grid"],
                          "rows_row_backed": ceiling["rows_row_backed"],
                          "row_budget": ROW_BUDGET,
                          "round_admitted":
                              ceiling["round"]["admitted"]}},
            {"id": "host_apply_serial",
             "residue": "the host apply/pack plane ran serial on one "
                        "thread; at 100k CQs the apply dominated the "
                        "burst cycle (~1.4k workloads/s end to end)",
             "status": "reduced",
             "flag": "KUEUE_TPU_HOST_WORKERS",
             "mechanism": "worker-pool host plane: cache rebuild "
                          "fan-out, dirty-CQ pack walk, requeue "
                          "wakeups and WAL segment commits partition "
                          "by cohort forest / queue / segment and run "
                          "on a fork-join pool; WAL seq stamped "
                          "serially pre-fan-out keeps replay "
                          "byte-identical",
             "evidence": {
                 "apply_pack_speedup":
                     host_pool["apply_pack_speedup"],
                 "plane_overlap_speedup":
                     host_pool["plane_overlap_speedup"],
                 "decisions_identical":
                     host_pool["decisions_identical"],
                 "bulk_apply_e2e_speedup":
                     top["host_apply_speedup"],
                 "apply_vs_classic_e2e":
                     top["host_apply_speedup_vs_classic"],
                 "cores_available": host_pool["cores_available"]}},
            {"id": "wal_single_thread_regression",
             "residue": "the sharded WAL cost 0.84x on a single "
                        "appender (stripe tax with no concurrency to "
                        "win back)",
             "status": ("closed"
                        if wal_block["commit_speedup"] >= 0.95
                        else "reduced"),
             "flag": "KUEUE_TPU_WAL_SHARDS",
             "mechanism": "appender census: the sharded WAL routes "
                          "every op to one hot segment until >= 2 "
                          "appenders register (the host pool "
                          "registers its workers); striping engages "
                          "only when concurrency exists — the residue "
                          "left is the per-op seq stamp the merged "
                          "replay needs",
             "evidence": {
                 "commit_speedup": wal_block["commit_speedup"],
                 "collapsed_segments":
                     wal_block["collapsed_segments"],
                 "striped_segments": wal_block["striped_segments"],
                 "replay_parity": wal_block["replay_parity"],
                 "soak_workloads_per_s": soak_rate}},
            {"id": "lazy_heap_low_churn",
             "residue": "lazy heap repair cost 0.83x at 1 touch/key "
                        "(overlay bookkeeping with nothing to "
                        "amortize)",
             "status": "closed",
             "flag": "KUEUE_TPU_LAZY_HEAP",
             "mechanism": "adaptive repair: an EWMA of measured "
                          "touches-per-key demotes the overlay to the "
                          "eager sift below 2 touches/key and "
                          "re-promotes when churn returns; flips only "
                          "at empty-overlay boundaries so order "
                          "parity is structural",
             "evidence": {
                 "heap_speedup_touches_1": heap_t1,
                 "heap_speedup_touches_8": heap_t8,
                 "order_parity": heap_micro["order_parity"]}},
        ],
        "walls": [
            {"id": "preempting_rows",
             "wall": "budget rows now scale with PREEMPTING-forest "
                     "rows, so the 2^19 budget caps preempting rows "
                     f"near {ROW_BUDGET}; probed at {ceiling['cqs']} "
                     f"CQs with {ceiling['rows_packed']} budget rows "
                     f"({ceiling['preempt_cohorts']} preempting "
                     "cohorts) — a universe with >= 524k preempting "
                     "rows still poisons to the host path"},
            {"id": "distinct_ts_seq_wall",
             "wall": "the admission-seq gate stays GLOBAL (dense rank "
                     "over distinct admitted reservation timestamps, "
                     "20-bit field); the ceiling preload admits one "
                     "wave in one round so timestamps collapse — a "
                     "universe with >= 2^20 DISTINCT admitted "
                     "timestamps still poisons in-kernel preemption "
                     "modeling"},
            {"id": "apply_per_admission_wall",
             "wall": "the e2e apply wall is per-admission-dominated: "
                     "profiled at ~135us/admission across "
                     "prepare/assume/slot-assignment (plus the "
                     "O(ready-CQs) heads pop/park walk), while a "
                     "deduped requeue storm costs ~66us — so the "
                     "cycle-dedupe levers (bulk apply, lazy heap, "
                     "pool) each move <10% of this regime's apply "
                     "wall and the single-flag bulk A/B measures "
                     f"~{top['host_apply_speedup']}x (r18's ~1.0x "
                     "was structural, not measurement noise: r13's "
                     "incremental settles + batched finish API "
                     "already removed the redundancy); closing it "
                     "needs per-admission-chain work — "
                     "slot-assignment memoization, peek-based heads "
                     "collection — not more dedupe"},
            {"id": "single_core_wall",
             "wall": f"this box exposes "
                     f"{host_pool['cores_available']} core(s), so the "
                     "pooled host plane can only overlap GIL-released "
                     "I/O (WAL flush+fsync, measured "
                     f"{host_pool['plane_overlap_speedup']}x at "
                     f"{args.workers} workers) — CPU-bound apply work "
                     "gains from the pool only with real cores; one "
                     f"soak round at {ceiling['cqs']} CQs costs "
                     f"{ceiling['round']['wall_s']}s wall and the "
                     f"soak sustained {soak_rate} workloads/s at "
                     f"{soak_block['cqs']} CQs"},
        ],
    }

    tail = {
        "metric": "active_cqs_at_ceiling_under_row_budget",
        "unit": "active CQs (each holding pending work) packed with "
                "head-pack budget rows under the kernel's 2^19 "
                "composite-key budget, one admission round completed, "
                "decisions bit-identical to the row-backed arm at "
                "every probed curve size",
        "value": ceiling["active_cqs_pending"],
        "cqs": top["cqs"],
        "host_apply_speedup_at_max_cqs": top["host_apply_speedup"],
        "pack_speedup_at_max_cqs": top["pack_speedup"],
        "seed": args.seed,
        "quick": bool(args.quick),
        "mesh": mesh_info(0, dev),
        "sizes": sizes,
        "curve": curve,
        "parity": parity,
        "ceiling": ceiling,
        "head_pack": head_pack,
        "host_pool": host_pool,
        "aggregate": aggregate,
        "heap": heap_block,
        "wal_shard": wal_block,
        "soak": soak_block,
        "residues": residues,
        "control": drift["control"],
        "environment_drift": drift,
        "wall_s_total": round(time.perf_counter() - t_start, 1),
    }
    ok = (parity["planes_identical_all"]
          and parity["decisions_identical_all"]
          and parity["decisions_identical_nobulk_all"]
          and parity["decisions_identical_classic_all"]
          and parity["max_res_ts_equal_all"]
          and host_pool["decisions_identical"]
          and ceiling["packed_under_budget"]
          and heap_micro["order_parity"]
          and wal_block["replay_parity"]
          and soak_block["completed"])
    log(f"scale soak done ({tail['wall_s_total']}s total)")
    return tail, ok


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    tail, ok = run(args)
    print(json.dumps(tail))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(tail, f, indent=1)
            f.write("\n")
        log(f"wrote {args.out}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
