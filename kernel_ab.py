#!/usr/bin/env python3
"""Times kernels of the kueue_tpu_torch package under a checkout, on
inputs that every commit of the port builds alike, so that two commits
can be compared in one run on one card (run it on each checkout in
turns: parent, change, change, parent).

    python3 kernel_ab.py CHECKOUT [LABEL] [--cases PATH] [--split DIR]

Prints one JSON line: the card, and per case the ms per launch (CUDA
events around back-to-back launches behind a busy stream) and a digest
of the outputs:

- ``best_fit_descend`` / ``split_across_roots`` on tas-4k's tree
  (level sizes 8, 128, 4,096: runs of 16 and 32 children), R = 3,
  BestFit, a count that fits and one that does not;
- ``fs_admit_scan`` on ``testing.FS_SHAPES``' north-star row (1,000
  CQs, 200 cohorts, 1,024 heads, ~350 forests) and on one forest
  holding the 1,000 CQs and 200 cohorts (the worst case for a block
  per forest);
- ``admit_scan`` on the north-star probe's flat 1,000 heads x 1,000
  CQs in 64 cohorts (``probe_flat``), on the largest of the first four
  calls of the perf scenario drained per cycle (``bench_cycle``), and
  on one forest of 1,000 CQs under 64 cohorts with 1,000 heads
  (``one_forest``); where the checkout's launcher takes the forest
  tables, also with them (``*_tables``);
- ``burst_cycles`` on the perf scenario's burst window and the
  north-star (1,000-CQ) burst window that ``chip_smoke.py`` times (the
  last window kept of each drain, a window with preemption), and on one
  forest of 1,000 CQs (``burst_one_forest``: ``testing.burst_synthetic``
  with every CQ under one cohort).

- ``admit_scan_preempt`` on the north-star run's 1,000-gang
  preemption cycle (``preempt_northstar``: the call of its per-cycle
  run with the most preempting heads) and on the perf scenario's
  preemption cycle with the most preempting heads
  (``preempt_bench``); where the checkout's launcher takes the forest
  tables, with them (``*_tables``);
- ``kq_fs_merge_order`` on 1,000 rounds over 2 and over 8 shards
  (``merge_2``, ``merge_8``: ``testing.merge_case``, seeded);
- ``minimal_preemptions_batch`` on the perf scenario's call with the
  most candidates (``search_bench``), on jobs-tas-4k's (``search_jobs``:
  its preemptor's single searches over the whole plane) and on
  ``testing.SEARCH_SHAPES``' row 5, seeded (``search_wide``: 256
  searches, K = 128, six CQs, F = 2);
- ``admit_scan_forests`` on the north-star probe's call
  (``forest_probe``: 1,000 heads in 64 forests) and on the north-star
  run's call with the most heads (``forest_northstar``);
- ``kq_classify_heads`` on the probe's classify (``classify_probe``:
  100,000 heads x 1,000 CQs, S = 4, R = 3, no pairs) and its 1,000
  scanned heads with the decision pairs (``classify_pairs``), and
  ``kq_cycle_order`` on those 1,000 heads (``order_probe``), on the
  16d dry run's first cycle (``order_dryrun``: the contended entry
  scenario, 64 CQs, 192 workloads) and on ``testing.order_case`` at
  10,000 heads (``order_wide``), all seeded (``scenarios.probe_synth``,
  ``scenarios.packed_cycle``), each order case also as the stable
  ``torch.argsort`` of the composed key (``library_ms``);
- ``kq_cq_avail`` on the probe's planes (``cq_avail_probe``: 1,000 CQs
  in 64 cohorts, its usage0), the 16d dry run's first cycle
  (``cq_avail_dryrun``) and a cohort chain 17 levels deep over 1,000
  CQs (``cq_avail_deep``), seeded, each with the route it took;
- ``kq_scatter_rows`` on the call of chip_smoke.py's 15c drain with the
  most rows (``scatter_15c``: 13 planes of 250 rows, captured on first
  use) and on every row of that shard (``scatter_wide``: Dp = 256,
  seeded values), the checkout's launcher on per-plane values or on the
  packed buffer, each digest over the planes written;
- the 15c drain itself, twice (``resident_15c``): per resident hit the
  host seconds of the scatter, its host-to-device copies and launches,
  and a digest of the records;
- ``drs_components`` on phase 9's shape (``drs_phase9``: 1,000 CQs
  under 200 root cohorts, F = R = 1, depth 2), on the probe's planes
  (``drs_probe``: 1,000 CQs in 64 cohorts, F = 12, R = 3) and on a
  cohort chain 17 levels deep over 1,000 CQs (``drs_deep``, F = 12, R =
  3), seeded, each with the kernel's own µs by the profiler
  (``kernel_us``: the ``drs_components`` kernel alone) beside the
  wrapper's ms, the device µs of everything a call issues
  (``device_us``) and the route where the checkout records one.

The captured inputs (probe, perf scenario, bursts, preemption cycles)
are built on first
use by driving the checkout's scenarios on the card and saved to PATH
(default ``.kueue_tpu_torch_build/kernel_ab_cases.pt`` beside this
script); later runs load them, so every checkout times the same inputs.

``--split DIR`` instead times the phases inside the flat
``admit_scan``, ``burst_cycles``, ``admit_scan_preempt``,
``minimal_preemptions_batch`` and ``admit_scan_forests`` (whichever
designs the checkout has: the single-block ones, the forest-parallel
flat scan and burst with the single-block preempt scan, or the scans
on the shared forest layout of ``flat_forest.cuh``; a block or a warp
per search; a block per forest or the flat layout): it copies the
checkout's kernel sources into DIR, inserts ``clock64()`` phase sums
read by thread 0 of each block (lane 0 of each warp in the
warp-per-search design, a row per search) into the copies of those
kernels and of ``kq_classify_heads`` and ``kq_cycle_order``, builds the
copies there and runs them on the same inputs.  It
prints per phase the cycles of block 0 and of the block (or search)
with the most cycles, and the same as µs at the clock that block 0's
``%globaltimer`` span gives.  The search's phases are staging, the
forward loop and the reverse loop (with their step counts); the forest
scan's the row copy, the head compaction and the entries.  The
classify's: in the thread-per-head design the head loads, the slot loop
(pair loads, votes and walk interleaved) and the stores; in the
lane-per-slot design the loads with the pair votes, the slot ballots,
the walk and the stores.  The order's: the key build, the register and shuffle
stages, the shared (or global) stages with their count, the write-out.
The CQ availability's: in the staged design the staging (with the CQ's
own row of cells), the chain's resolution in shared memory, the loads
of every level (their values consumed before the mark) and the fold
with the stores; the walk design as one phase.  The row scatter's: the
block-per-pair design's row read and copy loop, or the warp-per-pair
design's read of the row and its values with the copy as one phase.
``drs_components``': in the (node, column) design the lanes' own cells
(with the staging of parent[] on the staged route), the chain with its
level loads and fold, the (node, resource) sums and the stores; the
thread-per-(node, resource) design as one phase."""

from __future__ import annotations

import inspect
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path


def event_ms(fn, reps: int) -> float:
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def digest(*tensors) -> int:
    import torch
    return sum(int((t.long().flatten() * torch.arange(
        1, t.numel() + 1, device=t.device)).sum()) for t in tensors)


def flat(x):
    """Outputs as a flat tuple of tensors (the burst's carry flattened)."""
    if not isinstance(x, tuple):
        return (x,)
    return tuple(t for y in x for t in flat(y))


def forest_table(parent):
    """(forest_of_node [N] int32, n_forests): each node's tree, numbered
    in order of the roots' indices."""
    import numpy as np
    parent = np.asarray(parent, dtype=np.int64)
    root = np.arange(len(parent))
    while True:
        up = np.where(parent[root] >= 0, parent[root], root)
        if np.array_equal(up, root):
            break
        root = up
    _, fon = np.unique(root, return_inverse=True)
    return fon.astype(np.int32), int(fon.max()) + 1


# -- captured inputs ---------------------------------------------------------

def capture_cases() -> dict:
    """Drive the checkout's probe, perf scenario and north-star burst on
    the card and keep the kernel inputs to time (CPU copies)."""
    import numpy as np
    import torch
    from kueue_tpu_torch import scenarios
    from kueue_tpu_torch.ops import burst, cycle, solver

    def cpu(args):
        return tuple(a.cpu() if isinstance(a, torch.Tensor) else a
                     for a in args)

    out = {}
    # the probe's flat scan: solve_cycle over 1,000 heads x 1,000 CQs
    kept = []
    real = cycle.admit_scan

    def keep_scan(*args, **kw):
        kept.append((cpu(args), {"depth": kw["depth"]}))
        return real(*args, **kw)
    heads, depth = scenarios.probe_synth(W=1000, C=1000, cohorts=64, seed=1)
    cycle.admit_scan = keep_scan
    try:
        cycle.solve_cycle(*[torch.from_numpy(np.ascontiguousarray(a)).cuda()
                            for a in heads], depth=depth, run_scan=True)
    finally:
        cycle.admit_scan = real
    out["probe_flat"] = kept[-1]

    # the perf scenario per cycle: the largest of the first four scans
    kept = []
    real = solver.admit_scan

    def keep_solver(*args, **kw):
        if len(kept) < 4:
            kept.append((cpu(args), {"depth": kw["depth"]}))
        return real(*args, **kw)
    solver.admit_scan = keep_solver
    try:
        d, clock, total, waves = scenarios.build_bench(1.0, device="cuda")
        scenarios.run_bench(d, clock, total, waves)
    finally:
        solver.admit_scan = real
    out["bench_cycle"] = max(kept, key=lambda c: c[0][8].shape[0])
    del d

    # the bursts: the last window kept of each drain, as chip_smoke.py
    for label in ("burst_bench", "burst_northstar"):
        kept = []
        real = burst.burst_cycles

        def keep_burst(*args, **kw):
            res = real(*args, **kw)
            if len(kept) < 4 or (len(kept) < 6 and bool(
                    (res[1] == burst.KIND_PREEMPT).any())):
                kept.append((cpu(args), dict(kw)))
            return res
        burst.burst_cycles = keep_burst
        try:
            if label == "burst_bench":
                d, clock, total, waves = scenarios.build_bench(
                    1.0, device="cuda")
                scenarios.drain_bench_burst(d, clock, total, waves)
            else:
                d, clock, total, wave = scenarios.build_northstar(
                    1000, 100_000, device="cuda")
                scenarios.northstar_burst(d, clock, wave, cycles=30)
        finally:
            burst.burst_cycles = real
        args, kw = kept[-1]
        kw.pop("node_table", None)
        kw.pop("device", None)
        out[label] = (args, kw)
        del d
    return out


PREEMPT_CASES = ("preempt_bench", "preempt_northstar")
# the batched search and the forest scan on their paths (captured with
# the preemption cycles); search_wide is seeded (synthetic_cases)
SEARCH_CASES = ("search_bench", "search_jobs", "search_wide")
FOREST_CASES = ("forest_probe", "forest_northstar")
CYCLE_CASES = PREEMPT_CASES + ("search_bench", "search_jobs",
                               "forest_probe", "forest_northstar")


def capture_cycle_cases() -> dict:
    """Drive the perf scenario, the north-star run and the job front
    door per cycle on the card, and the north-star probe's forest scan,
    keeping CPU copies of the inputs to time: the preemption cycle with
    the most preempting heads of the perf scenario and of the north-star
    run (admit_scan_preempt), the minimal_preemptions_batch call with
    the most candidates (entries of cand_cq >= 0) of the perf scenario
    and of jobs-tas-4k (the batched searches, or the single searches
    over the whole plane that jobs-tas-4k's preemptor runs), the probe's
    admit_scan_forests call and the north-star run's admit_scan_forests
    call with the most heads."""
    import numpy as np
    import torch
    from kueue_tpu_torch import probe, scenarios
    from kueue_tpu_torch.ops import (cycle, preemption_kernel,
                                     preemption_solver, solver)

    kept: dict[str, list] = {}

    def keeper(module, attr, label, size):
        real = getattr(module, attr)

        def keep(*args, **kw):
            call = (tuple(a.cpu() if isinstance(a, torch.Tensor) else a
                          for a in args), dict(kw))
            calls = kept.setdefault(label, [])
            if not calls or size(call[0]) > size(calls[0][0]):
                calls[:] = [call]
            return real(*args, **kw)
        setattr(module, attr, keep)
        return module, attr, real

    def n_pre(a):
        return int(a[16].sum())

    def n_cands(a):
        return int((a[9] >= 0).sum())

    def n_heads(a):
        return int((a[8] >= 0).sum())

    def drive(patches, fn):
        undo = [keeper(*p) for p in patches]
        try:
            fn()
        finally:
            for module, attr, real in undo:
                setattr(module, attr, real)
        if hasattr(scenarios, "release"):
            scenarios.release()
        torch.cuda.synchronize()

    def bench():
        d, clock, total, waves = scenarios.build_bench(1.0, device="cuda")
        scenarios.run_bench(d, clock, total, waves)

    def northstar():
        d, clock, total, wave = scenarios.build_northstar(
            1000, 100_000, device="cuda")
        scenarios.run_northstar(d, clock, wave, cycles=30)

    def jobs():
        with scenarios.restore_gates():
            d, clock, mgr, plan = scenarios.build_jobs(device="cuda")
            scenarios.run_jobs(d, clock, mgr, plan)

    def probe_forest():
        _, name, args, kw = probe.probe_calls()[2]
        getattr(cycle, name)(*[torch.from_numpy(
            np.ascontiguousarray(a)).cuda() for a in args], **kw)

    # the batched searches of a cycle (preemption_solver), and the
    # single searches over the whole plane (ops.preemption_kernel
    # minimal_preemptions, S = 1) that jobs-tas-4k's preemptor runs
    def search(label):
        return [(m, "minimal_preemptions_batch", label, n_cands)
                for m in (preemption_solver, preemption_kernel)]
    drive([(solver, "admit_scan_preempt", "preempt_bench", n_pre)]
          + search("search_bench"), bench)
    drive([(solver, "admit_scan_preempt", "preempt_northstar", n_pre),
           (solver, "admit_scan_forests", "forest_northstar", n_heads)],
          northstar)
    drive(search("search_jobs"), jobs)
    drive([(cycle, "admit_scan_forests", "forest_probe", n_heads)],
          probe_forest)
    out = {}
    for label, calls in kept.items():
        args, kw = calls[0]
        keys = ("depth",) if label.startswith("preempt") else (
            "depth", "n_forests", "max_forest_wl")
        out[label] = (args, {k: kw[k] for k in keys if k in kw})
    return out


def synthetic_cases(testing) -> dict:
    """The one-forest worst cases of both kernels and the round
    merges, seeded."""
    import numpy as np
    c = testing.admit_cycle(np.random.default_rng(7), n_cqs=1000,
                            n_cohorts=64, depth=3, F=12, W=1000, R=3,
                            roots=1)
    one = (testing.admit_args(c), {"depth": c["depth"]})
    args, kw = testing.burst_synthetic(np.random.default_rng(7), C=1000,
                                       per=1000, M=16, K=4)
    out = {"one_forest": one, "burst_one_forest": (args, kw)}
    # testing.SEARCH_SHAPES' row 5: 256 searches, K = 128, six CQs, F = 2
    S, n_valid, K, n_c, n_cqs, n_coh, depth, F = testing.SEARCH_SHAPES[4]
    c = testing.preemption_searches(np.random.default_rng(7), S=S,
                                    n_valid=n_valid, K=K, n_cands=n_c,
                                    n_cqs=n_cqs, n_cohorts=n_coh,
                                    depth=depth, F=F)
    out["search_wide"] = (testing.search_args(c), {"depth": c["depth"]})
    for S in (2, 8):
        winners, head_of = testing.merge_case(np.random.default_rng(S),
                                              W=1000, S=S)
        out[f"merge_{S}"] = ((winners, head_of), {"W": 1000})
    return out


PHASE1_CASES = ("classify_probe", "classify_pairs", "order_probe",
                "order_dryrun", "order_wide")


def phase1_cases(scenarios, testing) -> dict:
    """The phase-1 kernels' inputs, seeded: the probe's classify of
    100,000 heads and of its 1,000 scanned heads (with the pairs), the
    order of those 1,000 heads and of the 16d dry run's first cycle (the
    borrows of the plain classify), and ``testing.order_case`` at 10,000
    heads."""
    import numpy as np
    import torch
    from kueue_tpu_torch.ops import cycle
    from kueue_tpu_torch.parallel import cycle_args

    def classify_inputs(planes, depth):
        (usage0, subtree, guaranteed, borrow_cap, has_blim, parent, nominal,
         slot_fr, slot_valid, can_pb, wl_cq, wl_req, prio, ts) = planes
        C, W = slot_fr.shape[0], wl_cq.shape[0]
        avail0, potential0 = cycle.cq_avail_plain(
            usage0, subtree, guaranteed, borrow_cap, has_blim, parent,
            n_cqs=C, depth=depth)
        heads = (wl_cq, wl_req, torch.zeros(W, dtype=torch.int32), slot_fr,
                 slot_valid, nominal, usage0, subtree, parent, can_pb,
                 torch.ones(C, dtype=torch.bool),
                 torch.zeros(C, dtype=torch.bool), avail0, potential0)
        return heads, (prio, ts.to(torch.float32))

    out = {}
    for label, W, seed in (("classify_probe", 100_000, 0),
                           ("classify_pairs", 1000, 1)):
        planes, depth = scenarios.probe_synth(W=W, C=1000, cohorts=64,
                                              seed=seed)
        heads, (prio, ts) = classify_inputs(
            [torch.from_numpy(np.ascontiguousarray(a)) for a in planes],
            depth)
        pairs = label == "classify_pairs"
        out[label] = (heads, {"pairs": pairs})
        if pairs:
            borrows0 = cycle.classify_heads_plain(*heads, pairs=True)[1]
            out["order_probe"] = ((borrows0, prio, ts), {})
    _, _, _, packed = scenarios.packed_cycle(
        device="cpu", n_cohorts=16, cqs_per_cohort=4, n_flavors=2,
        n_workloads=192, contended=True)
    planes = cycle_args(packed, device="cpu")
    borrows0 = cycle.solve_cycle_plain(*planes, depth=packed.depth,
                                       run_scan=False)[5]
    out["order_dryrun"] = ((borrows0, planes[12],
                            planes[13].to(torch.float32)), {})
    out["order_wide"] = (tuple(torch.from_numpy(a) for a in
                               testing.order_case(
                                   np.random.default_rng(10_000), 10_000)),
                         {})
    return out


def phase1_calls(kernels, cases):
    """(case, callable, library callable or None) for the phase-1 cases:
    the order's library call is the stable argsort of the composed key
    (``chip_smoke.cycle_order_key``, built once)."""
    import torch
    from chip_smoke import cycle_order_key
    calls = []
    for case in PHASE1_CASES:
        args, kw = cases[case]
        args = to_card(args)
        if case.startswith("order"):
            key = cycle_order_key(*args)
            calls.append((case, lambda a=args: kernels.kq_cycle_order(*a),
                          lambda k=key: torch.argsort(k, stable=True)))
        else:
            calls.append((case, lambda a=args, k=kw:
                          kernels.kq_classify_heads(*a, **k), None))
    return calls


AVAIL_CASES = ("cq_avail_probe", "cq_avail_dryrun", "cq_avail_deep")
DRS_CASES = ("drs_phase9", "drs_probe", "drs_deep")
SCATTER_CASES = ("scatter_15c", "scatter_wide")


def avail_cases(scenarios, testing) -> dict:
    """kq_cq_avail's inputs, seeded: the probe's planes (1,000 CQs in 64
    cohorts, its usage0), the 16d dry run's first cycle (the contended
    entry scenario: 64 CQs in 16 cohorts) and a cohort chain 17 levels
    deep over 1,000 CQs (F = 12)."""
    import numpy as np
    import torch
    from kueue_tpu_torch.parallel import cycle_args
    planes, depth = scenarios.probe_synth(W=1000, C=1000, cohorts=64, seed=1)
    out = {"cq_avail_probe": (
        tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in planes[:6]),
        {"n_cqs": int(planes[6].shape[0]), "depth": depth})}
    _, _, _, packed = scenarios.packed_cycle(
        device="cpu", n_cohorts=16, cqs_per_cohort=4, n_flavors=2,
        n_workloads=192, contended=True)
    a = cycle_args(packed, device="cpu")
    out["cq_avail_dryrun"] = (tuple(a[:6]), {
        "n_cqs": int(a[6].shape[0]), "depth": packed.depth})
    c = testing.solve_cycle_planes(np.random.default_rng(17), n_cqs=1000,
                                   n_cohorts=16, depth=2, F=12, W=8,
                                   chain=True)
    out["cq_avail_deep"] = (
        tuple(torch.from_numpy(c[k]) for k in testing.SOLVE_ARGS[:6]),
        {"n_cqs": 1000, "depth": c["depth"]})
    return out


def drs_cases(scenarios, testing) -> dict:
    """drs_components' inputs, seeded (``testing.drs_case``, which every
    checkout has): phase 9's shape, the probe's planes (F = 12 as 4
    flavors x 3 resources), a cohort chain 17 levels deep."""
    import numpy as np
    import torch
    out = {}
    args, kw = testing.drs_case(np.random.default_rng(9), n_cqs=1000,
                                n_cohorts=200, depth=2, F=1, R=1,
                                wl_req=False)
    out["drs_phase9"] = (args, kw)
    planes, depth = scenarios.probe_synth(W=8, C=1000, cohorts=64, seed=1)
    fr = (np.arange(planes[0].shape[1]) % 3).astype(np.int32)
    out["drs_probe"] = (tuple(np.ascontiguousarray(a) for a in planes[:6])
                        + (fr,), {"n_resources": 3, "depth": depth})
    args, kw = testing.drs_case(np.random.default_rng(17), n_cqs=1000,
                                n_cohorts=16, depth=2, F=12, R=3,
                                wl_req=False, chain=True)
    out["drs_deep"] = (args, kw)
    return {k: (tuple(torch.from_numpy(a) for a in args), kw)
            for k, (args, kw) in out.items()}


def capture_scatter_case() -> dict:
    """Drive the sustained drain at north-star width on 4 virtual shards
    of the card (chip_smoke.py's 15c) and keep, of the first four
    resident scatters, the one with the most rows, as the kernels line's
    ``most_rows`` does: (planes, rows, vals) on the CPU, whichever
    signature the checkout's ``parallel.sharded.scatter_rows`` has
    (per-plane values, or the packed buffer and its row count)."""
    import torch
    from kueue_tpu_torch import scenarios
    from kueue_tpu_torch.parallel import sharded
    kept = []
    real = sharded.scatter_rows

    def keep(planes, *rest):
        if len(kept) < 4:
            planes_c = tuple(p.clone() for p in planes)   # before the write
            if isinstance(rest[1], int):       # (buf, count)
                rows, vals = sharded.unpack_scatter_rows(planes, *rest)
            else:                              # (rows, vals)
                rows, vals = rest
            kept.append((tuple(p.cpu() for p in planes_c), rows.cpu(),
                         tuple(v.cpu() for v in vals)))
        return real(planes, *rest)
    sharded.scatter_rows = keep
    try:
        with sharded.virtual_mesh("cuda:0", 4):
            scenarios.sustained_drain(device="cuda", n_cqs=1000, runtime=30,
                                      shards=4)
    finally:
        sharded.scatter_rows = real
    if hasattr(scenarios, "release"):
        scenarios.release()
    torch.cuda.synchronize()
    return {"scatter_15c": max(kept, key=lambda k: int(k[1].shape[0]))}


def resident_drain(drains: int = 2) -> dict:
    """chip_smoke.py's 15c drain (1,000 CQs, 4 virtual shards of the
    card) run ``drains`` times: per resident hit the host seconds of the
    resident scatter (``burst_resident_scatter_s``: pack, uploads and
    launches) and its host-to-device copies (tensor uploads made inside
    ``BurstSolver._scatter_resident``, counted for any checkout), the
    ``kq_scatter_rows`` launches and a digest of the records."""
    import hashlib
    import torch
    from kueue_tpu_torch import kernels, scenarios
    from kueue_tpu_torch.ops.burst import BurstSolver
    from kueue_tpu_torch.parallel import sharded
    inside, copies = [False], [0]
    real_scatter, real_to = BurstSolver._scatter_resident, torch.Tensor.to

    def scatter(self, *a, **k):
        inside[0] = True
        try:
            return real_scatter(self, *a, **k)
        finally:
            inside[0] = False

    def to(self, *a, **k):
        out = real_to(self, *a, **k)
        if inside[0] and self.device.type == "cpu" \
                and out.device.type == "cuda":
            copies[0] += 1
        return out
    BurstSolver._scatter_resident, torch.Tensor.to = scatter, to
    secs = hits = 0
    records = []
    before = kernels.LAUNCHES["kq_scatter_rows"]
    try:
        with sharded.virtual_mesh("cuda:0", 4):
            for _ in range(drains):
                r = scenarios.sustained_drain(device="cuda", n_cqs=1000,
                                              runtime=30, shards=4)
                secs += r["stats"]["burst_resident_scatter_s"]
                hits += r["stats"]["burst_resident_hits"]
                records.append(r["records"])
                del r
                if hasattr(scenarios, "release"):
                    scenarios.release()
    finally:
        BurstSolver._scatter_resident, torch.Tensor.to = real_scatter, real_to
    launches = kernels.LAUNCHES["kq_scatter_rows"] - before
    return dict(scatter_s_per_hit=secs / max(1, hits),
                copies_per_hit=copies[0] / max(1, hits),
                launches_per_hit=launches / max(1, hits), hits=hits,
                digest=hashlib.sha256(repr(records).encode()).hexdigest())


def scatter_wide(case):
    """Every row of the 15c case's 250-row shard dirty, padded to 256 by
    repeating the last, with seeded values of each plane's type."""
    import numpy as np
    import torch
    planes = case[0]
    n = planes[0].shape[0]
    Dp = 1 << max(0, n - 1).bit_length()
    rows = np.concatenate([np.arange(n), np.full(Dp - n, n - 1)])
    rng = np.random.default_rng(250)
    vals = []
    for p in planes:
        shape = (n,) + tuple(p.shape[1:])
        v = (torch.from_numpy(rng.random(shape) < 0.5) if p.dtype == torch.bool
             else torch.from_numpy(rng.integers(-5, 50, shape)).to(p.dtype))
        vals.append(torch.cat([v, v[-1:].expand((Dp - n,) + v.shape[1:])]))
    return (planes, torch.from_numpy(rows.astype(np.int32)), tuple(vals))


def load_cases(path: Path):
    """The captured cases from ``path``, capturing (and saving) those the
    file lacks."""
    import torch
    cases = torch.load(path, weights_only=False) if path.exists() else {}
    missing = not cases
    if not cases:
        cases = capture_cases()
    if any(k not in cases for k in CYCLE_CASES):
        cases.update(capture_cycle_cases())
        missing = True
    if "scatter_15c" not in cases:
        cases.update(capture_scatter_case())
        missing = True
    if missing:
        path.parent.mkdir(parents=True, exist_ok=True)
        torch.save(cases, path)
    return cases


def to_card(args):
    import numpy as np
    import torch
    out = []
    for a in args:
        if isinstance(a, np.ndarray):
            a = torch.from_numpy(np.ascontiguousarray(a))
        out.append(a.cuda() if isinstance(a, torch.Tensor) else a)
    return out


def admit_calls(kernels, cases):
    """(case, callable) for every admit_scan case, with the forest tables
    where the launcher takes them."""
    import torch
    takes = "forest_of_node" in inspect.signature(
        kernels.admit_scan).parameters
    calls = []
    for case in ("probe_flat", "bench_cycle", "one_forest"):
        args, kw = cases[case]
        args = to_card(args)
        calls.append((case, lambda a=args, k=kw: kernels.admit_scan(*a,
                                                                    **k)))
        if takes:
            fon, nf = forest_table(args[5].cpu().numpy())
            tk = dict(kw, forest_of_node=torch.from_numpy(fon).cuda(),
                      n_forests=nf)
            calls.append((case + "_tables",
                          lambda a=args, k=tk: kernels.admit_scan(*a, **k)))
    return calls


def preempt_calls(kernels, cases):
    """(case, callable) for every admit_scan_preempt case, with the
    forest tables where the launcher takes them."""
    import torch
    takes = "forest_of_node" in inspect.signature(
        kernels.admit_scan_preempt).parameters
    calls = []
    for case in PREEMPT_CASES:
        args, kw = cases[case]
        args = to_card(args)
        if takes:      # an error word per call: no read-back per launch
            kw = dict(kw, error=torch.zeros(1, dtype=torch.int32,
                                            device=args[0].device))
        calls.append((case, lambda a=args, k=kw:
                      kernels.admit_scan_preempt(*a, **k)))
        if takes:
            fon, nf = forest_table(args[5].cpu().numpy())
            tk = dict(kw, forest_of_node=torch.from_numpy(fon).cuda(),
                      n_forests=nf)
            calls.append((case + "_tables", lambda a=args, k=tk:
                          kernels.admit_scan_preempt(*a, **k)))
    return calls


def search_calls(kernels, cases):
    """(case, callable) for every minimal_preemptions_batch case."""
    calls = []
    for case in SEARCH_CASES:
        args, kw = cases[case]
        args = to_card(args)
        calls.append((case, lambda a=args, k=kw:
                      kernels.minimal_preemptions_batch(*a, **k)))
    return calls


def forest_calls(kernels, cases):
    """(case, callable) for every admit_scan_forests case."""
    calls = []
    for case in FOREST_CASES:
        args, kw = cases[case]
        args = to_card(args)
        calls.append((case, lambda a=args, k=kw:
                      kernels.admit_scan_forests(*a, **k)))
    return calls


def merge_calls(kernels, cases):
    """(case, callable) for the round merges."""
    calls = []
    for case in ("merge_2", "merge_8"):
        (winners, head_of), kw = cases[case]
        w, h = to_card(winners), to_card(head_of)
        calls.append((case, lambda w=w, h=h, k=kw:
                      kernels.kq_fs_merge_order(w, h, k["W"])))
    return calls


def avail_calls(kernels, cases):
    """(case, callable) for every kq_cq_avail case."""
    calls = []
    for case in AVAIL_CASES:
        args, kw = cases[case]
        args = to_card(args)
        calls.append((case, lambda a=args, k=kw: kernels.kq_cq_avail(*a,
                                                                     **k)))
    return calls


def drs_calls(kernels, cases):
    """(case, callable) for every drs_components case."""
    calls = []
    for case in DRS_CASES:
        args, kw = cases[case]
        args = to_card(args)
        calls.append((case, lambda a=args, k=kw:
                      kernels.drs_components(*a, **k)))
    return calls


def own_us(call, name: str, reps: int = 50) -> dict:
    """``reps`` calls behind a busy stream under the profiler
    (``profiling.DeviceClock``): the mean duration of ``name``'s own
    kernel, how many of its launches it recorded, and the device µs of
    everything a call issues (``device_us``)."""
    import torch
    from kueue_tpu_torch import kernels
    from kueue_tpu_torch.profiling import DeviceClock
    call()
    torch.cuda.synchronize()
    with DeviceClock() as clk:
        torch.cuda._sleep(100_000_000)
        for _ in range(reps):
            call()
    own = [t1 - t0 for n, v in clk.spans_us.items()
           if kernels.launcher_of(n) == name for t0, t1 in v]
    spans = [t1 - t0 for v in clk.spans_us.values() for t0, t1 in v]
    return dict(kernel_us=sum(own) / len(own) if own else None,
                kernel_records=len(own), device_us=sum(spans) / reps)


def scatter_calls(kernels, cases):
    """(case, callable, the planes it writes) for every kq_scatter_rows
    case: the checkout's launcher on per-plane values, or on the buffer
    that its ``ops.packing.pack_scatter_rows`` packs (uploaded once,
    outside the timing).  Each case writes its own copy of the planes."""
    import torch
    packed = "buf" in inspect.signature(kernels.kq_scatter_rows).parameters
    calls = []
    for case in SCATTER_CASES:
        planes, rows, vals = (cases["scatter_15c"] if case == "scatter_15c"
                              else scatter_wide(cases["scatter_15c"]))
        planes = tuple(to_card(planes))
        if packed:
            from kueue_tpu_torch.ops.packing import pack_scatter_rows
            buf = torch.from_numpy(pack_scatter_rows(
                rows.numpy(), [v.numpy() for v in vals])).cuda()
            calls.append((case, lambda p=planes, b=buf, n=len(rows):
                          kernels.kq_scatter_rows(p, b, n), planes))
        else:
            r, v = to_card([rows])[0], tuple(to_card(vals))
            calls.append((case, lambda p=planes, r=r, v=v:
                          kernels.kq_scatter_rows(p, r, v), planes))
    return calls


def burst_calls(kernels, cases):
    """(case, callable) for every burst case, with the node table built
    once (as the burst solver caches it with the structure)."""
    from kueue_tpu_torch.ops.burst import ARG_NAMES
    calls = []
    for case in ("burst_bench", "burst_northstar", "burst_one_forest"):
        args, kw = cases[case]
        args = to_card(args)
        a = dict(zip(ARG_NAMES, args))
        kw = dict(kw, node_table=kernels.burst_node_table(
            a["parent"], a["node_level"], a["forest_of_cq"], kw["G"],
            args[0].device))
        calls.append((case, lambda a=args, k=kw: kernels.burst_cycles(*a,
                                                                      **k)))
    return calls


# -- the phase split ------------------------------------------------------------

SPLIT_HEAD = r"""
#define KQ_SPLIT_BLOCKS 1024
#define KQ_SPLIT_P 24
__device__ unsigned long long kq_split_acc[KQ_SPLIT_BLOCKS * KQ_SPLIT_P];
__shared__ unsigned long long kq_split_s[KQ_SPLIT_P];
__shared__ long long kq_split_t;
__shared__ unsigned long long kq_split_ns0;
__device__ __forceinline__ unsigned long long kq_split_gt() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ void kq_split_start() {
  if (threadIdx.x == 0) {
    for (int p = 0; p < KQ_SPLIT_P; ++p) kq_split_s[p] = 0;
    kq_split_ns0 = kq_split_gt();
    kq_split_t = clock64();
  }
}
__device__ __forceinline__ void kq_split_mark(int p) {
  if (threadIdx.x == 0) {
    const long long n = clock64();
    kq_split_s[p] += n - kq_split_t;
    kq_split_t = n;
  }
}
__device__ __forceinline__ void kq_split_count(int p) {
  if (threadIdx.x == 0) kq_split_s[p] += 1;
}
__device__ __forceinline__ void kq_split_flush() {
  if (threadIdx.x == 0 && blockIdx.x < KQ_SPLIT_BLOCKS) {
    kq_split_s[14] = kq_split_gt() - kq_split_ns0;  // block's span, ns
    for (int p = 0; p < KQ_SPLIT_P; ++p) {
      kq_split_acc[blockIdx.x * KQ_SPLIT_P + p] += kq_split_s[p];
    }
  }
}
extern "C" int kq_split_TAG_read(unsigned long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(
      out, kq_split_acc, sizeof(kq_split_acc)));
}
extern "C" int kq_split_TAG_reset() {
  static unsigned long long zero[KQ_SPLIT_BLOCKS * KQ_SPLIT_P];
  return static_cast<int>(cudaMemcpyToSymbol(kq_split_acc, zero,
                                             sizeof(zero)));
}
"""

# phase names by slot; 14 is block 0's %globaltimer span in ns, and the
# slots named "n ..." are counts
ADMIT_PHASES = {0: "prologue", 1: "head loads", 2: "fit walk",
                3: "barrier/vote", 4: "charge", 5: "n entries"}
BURST_PHASES = {11: "target words zeroed", 0: "rebuild", 1: "heads",
                2: "classify", 3: "searches", 4: "order",
                5: "scan.copy", 6: "scan.sub_targets", 7: "scan.rebuild",
                8: "scan.fit", 9: "scan.charge", 10: "transitions",
                12: "n scan entries", 13: "n searches", 15: "n cycles"}


def _patch(text: str, pairs, what: str) -> str:
    for old, new in pairs:
        if text.count(old) != 1:
            raise SystemExit(f"--split: {what}: anchor found "
                             f"{text.count(old)} times: {old[:60]!r}")
        text = text.replace(old, new)
    return text


# the forest-parallel designs' phases (the same slots, other names)
FLAT_PHASES = {0: "count", 1: "stage", 2: "list", 3: "decide (warp 0)",
               5: "n entries (warp 0)"}
FOREST_BURST_PHASES = {**BURST_PHASES, 11: "stage + target words",
                       5: "scan.init", 6: "scan.rows",
                       7: "scan.chain update", 16: "transitions.members",
                       17: "transitions.evictions",
                       18: "transitions.finishes",
                       10: "transitions.carry and unpark"}


# the single-block admit_scan_preempt (the first CUDA design): thread 0's
# phases of each entry
PREEMPT_PHASES = {0: "prologue", 1: "fit + barrier", 2: "overlap",
                  3: "trial copy", 4: "target removals",
                  5: "fit after removal + barrier", 6: "used marks",
                  7: "charge + outputs", 8: "n entries",
                  9: "n preempt trials"}
# the warp-per-forest admit_scan_preempt: the shared prologue, then warp
# 0's entries
FOREST_PREEMPT_PHASES = {0: "count", 1: "stage", 2: "list",
                         3: "fit (warp 0)", 4: "overlap",
                         6: "target removals", 7: "fit after removal",
                         8: "chain sync", 9: "charge + outputs",
                         10: "n entries (warp 0)",
                         11: "n preempt trials (warp 0)"}


def split_preempt_single(src: Path, dst: Path) -> None:
    """The phase timers in the single-block admit_scan_preempt."""
    text = _patch((src / "admit_scan_preempt.cu").read_text(), [
        ('#include "admit_entry.cuh"\n',
         '#include "admit_entry.cuh"\n'
         + SPLIT_HEAD.replace("TAG", "preempt")),
        ("  extern __shared__ int smem[];\n",
         "  extern __shared__ int smem[];\n  kq_split_start();\n"),
        ("  for (int step = 0; step < W; ++step) {\n",
         "  kq_split_mark(0);\n  for (int step = 0; step < W; ++step) {\n"
         "    kq_split_count(8);\n"),
        ("    const bool admit = c.fit_mask[wi] && valid && fit_ok;\n",
         "    const bool admit = c.fit_mask[wi] && valid && fit_ok;\n"
         "    kq_split_mark(1);\n"),
        ("    const bool act_pre = is_pre && !overlap;\n",
         "    const bool act_pre = is_pre && !overlap;\n"
         "    kq_split_mark(2);\n"),
        ("      bool pre_f = true;\n",
         "      bool pre_f = true;\n      kq_split_count(9);\n"),
        ("        for (int n = 0; n < n_nodes; ++n) trial[n * F + f] = "
         "check[n * F + f];\n",
         "        for (int n = 0; n < n_nodes; ++n) trial[n * F + f] = "
         "check[n * F + f];\n        kq_split_mark(3);\n"),
        ("        }\n        const int avail = kq_available_at(t, trial, "
         "cq, f);\n",
         "        }\n        kq_split_mark(4);\n"
         "        const int avail = kq_available_at(t, trial, cq, f);\n"),
        ("      preempting = __syncthreads_and(pre_f) != 0;\n",
         "      preempting = __syncthreads_and(pre_f) != 0;\n"
         "      kq_split_mark(5);\n"),
        ("    const bool is_res = c.res_mask[wi] && valid;\n",
         "    kq_split_mark(6);\n"
         "    const bool is_res = c.res_mask[wi] && valid;\n"),
        ("      skip_out[wi] = is_pre && overlap;\n    }\n  }\n}\n",
         "      skip_out[wi] = is_pre && overlap;\n    }\n"
         "    kq_split_mark(7);\n  }\n  kq_split_flush();\n}\n"),
    ], "admit_scan_preempt.cu")
    (dst / "admit_scan_preempt.cu").write_text(text)


def split_shared_layout(src: Path, dst: Path) -> None:
    """The phase timers in flat_forest.cuh's prologue (both scans) and in
    each scan's decide loop."""
    header = _patch((src / "flat_forest.cuh").read_text(), [
        ("  __shared__ int s_n[3];      // nodes, heads, a counter / the "
         "list base\n",
         "  __shared__ int s_n[3];      // nodes, heads, a counter / the "
         "list base\n  kq_split_start();\n"),
        ("  const int n_nodes = s_n[0];\n",
         "  kq_split_mark(0);\n  const int n_nodes = s_n[0];\n"),
        ("  if (!shared) list = a.glist",
         "  kq_split_mark(1);\n  if (!shared) list = a.glist"),
        ("  return true;\n}\n", "  kq_split_mark(2);\n  return true;\n}\n"),
    ], "flat_forest.cuh")
    if "flat_decide(" in header:
        # the flat scans' decide loop in the header (admit_scan and
        # admit_scan_forests)
        header = _patch(header, [
            ("    if (((bits >> kOwnerShift) & 31) != warp) continue;\n",
             "    if (((bits >> kOwnerShift) & 31) != warp) continue;\n"
             "    kq_split_count(5);\n"),
            ("    decide(GlobalRows{a.t.parent, a.gusage, a.t, a.t.F});\n"
             "  }\n}\n",
             "    decide(GlobalRows{a.t.parent, a.gusage, a.t, a.t.F});\n"
             "  }\n  kq_split_mark(3);\n  kq_split_flush();\n}\n"),
        ], "flat_forest.cuh")
        for name, tag in (("admit_scan.cu", "admit"),
                          ("admit_scan_forests.cu", "forest")):
            (dst / name).write_text(_patch((src / name).read_text(), [
                ('#include "flat_forest.cuh"\n',
                 SPLIT_HEAD.replace("TAG", tag)
                 + '#include "flat_forest.cuh"\n')], name))
    (dst / "flat_forest.cuh").write_text(header)
    if "flat_decide(" in header:
        split_preempt_forest(src, dst)
        split_burst_forest(src, dst)
        return
    flat_src = _patch((src / "admit_scan.cu").read_text(), [
        ('#include "flat_forest.cuh"\n',
         SPLIT_HEAD.replace("TAG", "admit") + '#include "flat_forest.cuh"\n'),
        ("    if ((bits >> kOwnerShift) != warp) continue;\n",
         "    if ((bits >> kOwnerShift) != warp) continue;\n"
         "    kq_split_count(5);\n"),
        ("    flat_decide(a, rows, admitted, st.list, st.n_heads, st.col);\n"
         "  }\n}\n",
         "    flat_decide(a, rows, admitted, st.list, st.n_heads, st.col);\n"
         "  }\n  kq_split_mark(3);\n  kq_split_flush();\n}\n"),
    ], "admit_scan.cu")
    (dst / "admit_scan.cu").write_text(flat_src)
    split_preempt_forest(src, dst)
    split_burst_forest(src, dst)


def split_preempt_forest(src: Path, dst: Path) -> None:
    """The phase timers in the warp-per-forest admit_scan_preempt's
    decide loop."""
    pre_src = _patch((src / "admit_scan_preempt.cu").read_text(), [
        ('#include "flat_forest.cuh"\n',
         SPLIT_HEAD.replace("TAG", "preempt")
         + '#include "flat_forest.cuh"\n'),
        ("    if ((bits >> kOwnerShift) != warp) continue;\n",
         "    if ((bits >> kOwnerShift) != warp) continue;\n"
         "    kq_split_count(10);\n"),
        ("    const bool admit = (bits & kFit) && ok;\n",
         "    const bool admit = (bits & kFit) && ok;\n"
         "    kq_split_mark(3);\n"),
        ("      overlap = __any_sync(full, overlap);\n    }\n",
         "      overlap = __any_sync(full, overlap);\n    }\n"
         "    kq_split_mark(4);\n"),
        ("      __syncwarp();\n      bool pre_ok = true;\n",
         "      __syncwarp();\n      kq_split_mark(6);\n"
         "      kq_split_count(11);\n      bool pre_ok = true;\n"),
        ("      preempting = __all_sync(full, pre_ok);\n",
         "      preempting = __all_sync(full, pre_ok);\n"
         "      kq_split_mark(7);\n"),
        ("      sync_chains(check, trial, tg, tn, p.mt, depth, "
         "preempting);\n      __syncwarp();\n",
         "      sync_chains(check, trial, tg, tn, p.mt, depth, "
         "preempting);\n      __syncwarp();\n      kq_split_mark(8);\n"),
        ("      p.skip[wi] = is_pre && overlap;\n    }\n",
         "      p.skip[wi] = is_pre && overlap;\n    }\n"
         "    kq_split_mark(9);\n"),
        ("                   st.n_heads, st.col);\n  }\n}\n\n}  // "
         "namespace\n",
         "                   st.n_heads, st.col);\n  }\n"
         "  kq_split_flush();\n}\n\n}  // namespace\n"),
    ], "admit_scan_preempt.cu")
    (dst / "admit_scan_preempt.cu").write_text(pre_src)


def split_forest_designs(src: Path, dst: Path) -> None:
    """The phase timers in the forest-parallel flat admit_scan and the
    shared-memory burst_cycles."""
    flat_src = _patch((src / "admit_scan.cu").read_text(), [
        ('#include "admit_entry.cuh"\n',
         '#include "admit_entry.cuh"\n' + SPLIT_HEAD.replace("TAG", "admit")),
        ("  extern __shared__ int smem[];\n",
         "  extern __shared__ int smem[];\n  kq_split_start();\n"),
        ("  const int n_nodes = s_n[0];\n",
         "  kq_split_mark(0);\n  const int n_nodes = s_n[0];\n"),
        ("  if (!shared) list = a.glist",
         "  kq_split_mark(1);\n  if (!shared) list = a.glist"),
        ("  // 4. each warp decides its forests' entries\n",
         "  kq_split_mark(2);\n"),
        ("    flat_decide(a, rows, list, n_heads, col);\n  }\n}\n",
         "    flat_decide(a, rows, list, n_heads, col);\n  }\n"
         "  kq_split_mark(3);\n  kq_split_flush();\n}\n"),
        ("    if ((bits >> kOwnerShift) != warp) continue;\n",
         "    if ((bits >> kOwnerShift) != warp) continue;\n"
         "    kq_split_count(5);\n"),
    ], "admit_scan.cu")
    (dst / "admit_scan.cu").write_text(flat_src)
    split_burst_forest(src, dst)


def split_burst_forest(src: Path, dst: Path) -> None:
    """The phase timers in the shared-memory burst_cycles."""
    burst_src = _patch((src / "burst_cycles.cu").read_text(), [
        ('#include "quota.cuh"\n',
         '#include "quota.cuh"\n' + SPLIT_HEAD.replace("TAG", "burst")),
        ("  stage(a, s, g);\n",
         "  kq_split_start();\n  stage(a, s, g);\n"),
        ("    rebuild(a, s, g, s.ucq);\n    heads(a, s, mem);\n"
         "    __syncthreads();\n    classify(a, s, mem, s_dflags);\n"
         "    __syncthreads();\n",
         "    kq_split_mark(11);\n    rebuild(a, s, g, s.ucq);\n"
         "    kq_split_mark(0);\n    heads(a, s, mem);\n"
         "    __syncthreads();\n    kq_split_mark(1);\n"
         "    classify(a, s, mem, s_dflags);\n    __syncthreads();\n"
         "    kq_split_mark(2);\n"),
        ("      search_lane(a, s, g, l, c, k, mem, skey, sval, keep, s_int);\n",
         "      search_lane(a, s, g, l, c, k, mem, skey, sval, keep, s_int);\n"
         "      kq_split_count(13);\n"),
        ("    order(a, s, mem);\n    scan(a, s, g, k, mem, keep);\n"
         "    transitions(a, s, g, k, mem, s_int);\n  }\n",
         "    kq_split_mark(3);\n    order(a, s, mem);\n"
         "    kq_split_mark(4);\n    scan(a, s, g, k, mem, keep);\n"
         "    transitions(a, s, g, k, mem, s_int);\n    kq_split_mark(10);\n"
         "    kq_split_count(15);\n  }\n  kq_split_flush();\n"),
        ("s.used[w] = 0;\n  __syncthreads();\n",
         "s.used[w] = 0;\n  __syncthreads();\n  kq_split_mark(5);\n"),
        ("      if (act || marks) {\n",
         "      kq_split_mark(6);\n      if (act || marks) {\n"),
        ("      // the fit re-check on the lanes",
         "      kq_split_mark(7);\n      // the fit re-check on the lanes"),
        ("      const bool pre_now = act && pre_ok;\n",
         "      const bool pre_now = act && pre_ok;\n      kq_split_mark(8);\n"),
        ("  // evictions: committed targets release",
         "  kq_split_mark(16);\n  // evictions: committed targets release"),
        ("  // modeled finishes of this cycle",
         "  kq_split_mark(17);\n  // modeled finishes of this cycle"),
        ("  if (tid == 0) s_int[7] = 0;\n  __syncthreads();\n",
         "  if (tid == 0) s_int[7] = 0;\n  __syncthreads();\n"
         "  kq_split_mark(18);\n"),
        ("(overlap ? F_OVERLAP : 0);\n      }\n      __syncwarp();\n    }\n",
         "(overlap ? F_OVERLAP : 0);\n      }\n      __syncwarp();\n"
         "      kq_split_mark(9);\n      kq_split_count(12);\n    }\n"),
    ], "burst_cycles.cu")
    (dst / "burst_cycles.cu").write_text(burst_src)


# minimal_preemptions_batch and admit_scan_forests: the phases of one
# search (thread 0's, or lane 0's of each warp in the warp-per-search
# design, whose rows are searches) and of one forest (thread 0's of each
# block in the block-per-forest design; the shared layout's prologue and
# warp 0's entries in the flat_forest.cuh one)
SEARCH_PHASES = {0: "staging", 1: "forward loop", 2: "reverse loop",
                 3: "n forward steps", 4: "n reverse steps"}
FOREST_PHASES = {0: "row copy", 1: "head compaction", 2: "entries",
                 3: "n entries"}
FOREST_FLAT_PHASES = {0: "row copy (count)", 1: "row copy (stage)",
                      2: "head compaction", 3: "entries (warp 0)",
                      5: "n entries (warp 0)"}


# the phase sums of the warp-per-search design: lane 0 of each warp
# records its own search, one row per search
SPLIT_WARP_HEAD = r"""
#define KQ_SPLIT_ROWS 1024
#define KQ_SPLIT_P 24
__device__ unsigned long long kq_split_acc[KQ_SPLIT_ROWS * KQ_SPLIT_P];
__shared__ unsigned long long kq_split_s[32][KQ_SPLIT_P];
__shared__ long long kq_split_t[32];
__shared__ unsigned long long kq_split_ns0[32];
__device__ __forceinline__ unsigned long long kq_split_gt() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ void kq_split_start() {
  const int w = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    for (int p = 0; p < KQ_SPLIT_P; ++p) kq_split_s[w][p] = 0;
    kq_split_ns0[w] = kq_split_gt();
    kq_split_t[w] = clock64();
  }
}
__device__ __forceinline__ void kq_split_mark(int p) {
  const int w = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    const long long n = clock64();
    kq_split_s[w][p] += n - kq_split_t[w];
    kq_split_t[w] = n;
  }
}
__device__ __forceinline__ void kq_split_count(int p) {
  if ((threadIdx.x & 31) == 0) kq_split_s[threadIdx.x >> 5][p] += 1;
}
__device__ __forceinline__ void kq_split_flush() {
  const int w = threadIdx.x >> 5;
  const int row = blockIdx.x * (blockDim.x >> 5) + w;
  if ((threadIdx.x & 31) == 0 && row < KQ_SPLIT_ROWS) {
    kq_split_s[w][14] = kq_split_gt() - kq_split_ns0[w];
    for (int p = 0; p < KQ_SPLIT_P; ++p) {
      kq_split_acc[row * KQ_SPLIT_P + p] += kq_split_s[w][p];
    }
  }
}
extern "C" int kq_split_TAG_read(unsigned long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(
      out, kq_split_acc, sizeof(kq_split_acc)));
}
extern "C" int kq_split_TAG_reset() {
  static unsigned long long zero[KQ_SPLIT_ROWS * KQ_SPLIT_P];
  return static_cast<int>(cudaMemcpyToSymbol(kq_split_acc, zero,
                                             sizeof(zero)));
}
"""


def split_search_warp(src: Path, dst: Path) -> None:
    """The phase timers in the warp-per-search minimal_preemptions: each
    real search's lane 0, from the kernel's start to its outputs."""
    text = _patch((src / "minimal_preemptions.cu").read_text(), [
        ('#include "flat_forest.cuh"\n',
         SPLIT_WARP_HEAD.replace("TAG", "search")
         + '#include "flat_forest.cuh"\n'),
        ("  if (s >= p.S) return;\n",
         "  if (s >= p.S) return;\n  kq_split_start();\n"),
        ("  if constexpr (kShort) chain4(rows, pcq, depth, up);\n",
         "  if constexpr (kShort) chain4(rows, pcq, depth, up);\n"
         "  kq_split_mark(0);\n"),
        ("    if (code < 0) continue;\n    const int cq = code & kCqMask;\n",
         "    if (code < 0) continue;\n    kq_split_count(3);\n"
         "    const int cq = code & kCqMask;\n"),
        ("    fitted = fits(allow_b);\n  }\n  __syncwarp();\n",
         "    fitted = fits(allow_b);\n  }\n  __syncwarp();\n"
         "  kq_split_mark(1);\n"),
        ("      const int k = wd * 32 + b;\n",
         "      const int k = wd * 32 + b;\n      kq_split_count(4);\n"),
        ("  if (lane == 0) p.fitted[s] = fitted;\n}\n",
         "  if (lane == 0) p.fitted[s] = fitted;\n  kq_split_mark(2);\n"
         "  kq_split_flush();\n}\n"),
    ], "minimal_preemptions.cu")
    (dst / "minimal_preemptions.cu").write_text(text)


def split_search_block(src: Path, dst: Path) -> None:
    """The phase timers in the block-per-search minimal_preemptions."""
    text = _patch((src / "minimal_preemptions.cu").read_text(), [
        ('#include "quota.cuh"\n',
         '#include "quota.cuh"\n' + SPLIT_HEAD.replace("TAG", "search")),
        ("  extern __shared__ int smem[];\n",
         "  extern __shared__ int smem[];\n  kq_split_start();\n"),
        ("usage[i] = usage0[plane + i];\n  __syncthreads();\n",
         "usage[i] = usage0[plane + i];\n  __syncthreads();\n"
         "  kq_split_mark(0);\n"),
        ("    if (cq < 0) continue;\n",
         "    if (cq < 0) continue;\n    kq_split_count(3);\n"),
        ("  if (!fitted) {\n    for (int k = tid; k < K; k += T) mask[k] = 0;"
         "\n    if (tid == 0) fitted_out[s] = 0;\n    return;\n",
         "  kq_split_mark(1);\n"
         "  if (!fitted) {\n    for (int k = tid; k < K; k += T) mask[k] = 0;"
         "\n    if (tid == 0) fitted_out[s] = 0;\n    kq_split_flush();\n"
         "    return;\n"),
        ("    if (!mask[k]) continue;\n",
         "    if (!mask[k]) continue;\n    kq_split_count(4);\n"),
        ("  if (tid == 0) fitted_out[s] = 1;\n}\n",
         "  if (tid == 0) fitted_out[s] = 1;\n  kq_split_mark(2);\n"
         "  kq_split_flush();\n}\n"),
    ], "minimal_preemptions.cu")
    (dst / "minimal_preemptions.cu").write_text(text)


def split_forest_block(src: Path, dst: Path) -> None:
    """The phase timers in the block-per-forest admit_scan_forests."""
    text = _patch((src / "admit_scan_forests.cu").read_text(), [
        ('#include "admit_entry.cuh"\n',
         '#include "admit_entry.cuh"\n'
         + SPLIT_HEAD.replace("TAG", "forest")),
        ("  extern __shared__ int smem[];\n",
         "  extern __shared__ int smem[];\n  kq_split_start();\n"),
        ("  int count = 0;\n", "  kq_split_mark(0);\n  int count = 0;\n"),
        ("  const int n = min(count, max_forest_wl);\n",
         "  kq_split_mark(1);\n  const int n = min(count, max_forest_wl);\n"),
        ("    if (tid == 0) admitted[wi] = admit;\n  }\n}\n",
         "    if (tid == 0) admitted[wi] = admit;\n    kq_split_count(3);\n"
         "  }\n  kq_split_mark(2);\n  kq_split_flush();\n}\n"),
    ], "admit_scan_forests.cu")
    (dst / "admit_scan_forests.cu").write_text(text)


def split_search_forest(src: Path, dst: Path) -> tuple:
    """The phase timers in the checkout's minimal_preemptions and
    admit_scan_forests, whichever designs it has → (the search is a warp
    per search, the forest scan is on flat_forest.cuh)."""
    search_warp = "issue_cands(" in (
        src / "minimal_preemptions.cu").read_text()
    forest_flat = "flat_forest.cuh" in (
        src / "admit_scan_forests.cu").read_text()
    if search_warp:
        split_search_warp(src, dst)
    else:
        split_search_block(src, dst)
    if not forest_flat:
        split_forest_block(src, dst)
    return search_warp, forest_flat


# kq_classify_heads and kq_cycle_order: thread 0's phases (block 0 holds
# the order's one block)
CLASSIFY_THREAD_PHASES = {0: "head loads",
                          1: "slot loop (pair loads, votes, walk)",
                          2: "stores", 3: "pair stores"}
CLASSIFY_GROUP_PHASES = {0: "loads and pair votes", 1: "slot ballots",
                         2: "walk", 3: "stores"}
ORDER_PHASES = {0: "key build", 1: "register + shuffle stages",
                2: "shared (or global) stages", 3: "write-out",
                5: "n shared (or global) stages"}

# the order's global route (both designs' bitonic sort in scratch)
ORDER_GLOBAL_SPLIT = [
    ("  unsigned long long* lo = hi + P;\n",
     "  unsigned long long* lo = hi + P;\n  kq_split_start();\n"),
    ("  __syncthreads();\n  for (int k = 2; k <= P; k <<= 1) {\n",
     "  __syncthreads();\n  kq_split_mark(0);\n"
     "  for (int k = 2; k <= P; k <<= 1) {\n"),
    ("      __syncthreads();\n    }\n  }\n"
     "  for (int i = threadIdx.x; i < W; i += blockDim.x) {\n",
     "      __syncthreads();\n      kq_split_count(5);\n    }\n  }\n"
     "  kq_split_mark(2);\n"
     "  for (int i = threadIdx.x; i < W; i += blockDim.x) {\n"),
    ("order[i] = static_cast<int>(static_cast<unsigned>(lo[i] & "
     "0xffffffffull));\n  }\n}\n",
     "order[i] = static_cast<int>(static_cast<unsigned>(lo[i] & "
     "0xffffffffull));\n  }\n  kq_split_mark(3);\n  kq_split_flush();\n"
     "}\n"),
]


# kq_cq_avail: the staged design's staging (with the CQ's own row of
# cells), chain resolution, loads (their
# values consumed into a volatile word before the mark, so the loads'
# latency lands in their phase) and fold with the stores, summed over the
# chain's segments; the walk design (a thread per cell, the chain from
# global memory) as one phase
AVAIL_STAGED_PHASES = {0: "staging", 1: "chain resolution", 2: "loads",
                       3: "fold + stores"}
AVAIL_WALK_PHASES = {0: "walk (parent hops, cell loads, fold, stores)"}
AVAIL_STAGED_SPLIT = [
    ("  extern __shared__ int s_par[];\n  const int* par = t.parent;\n",
     "  extern __shared__ int s_par[];\n  const int* par = t.parent;\n"
     "  kq_split_start();\n"),
    ("  __syncthreads();\n  if (!live) return;\n",
     "  __syncthreads();\n  kq_split_mark(0);\n  if (!live) return;\n"),
    ("    // every level's five cells, all loads in flight before any is "
     "used\n",
     "    kq_split_mark(1);\n"
     "    // every level's five cells, all loads in flight before any is "
     "used\n"),
    ("    // the fold, top-down\n",
     "    {\n      int sink = 0;\n#pragma unroll\n"
     "      for (int i = 0; i < S; ++i) {\n"
     "        if (i < n_seg) sink ^= u[i] ^ sub[i] ^ g[i] ^ bc[i] ^ hb[i];\n"
     "      }\n"
     "      if (threadIdx.x == 0) kq_split_sink = sink;\n    }\n"
     "    kq_split_mark(2);\n    // the fold, top-down\n"),
    ("  const size_t o = static_cast<size_t>(c) * F + f;\n"
     "  avail[o] = a;\n  potential[o] = p;\n}\n",
     "  const size_t o = static_cast<size_t>(c) * F + f;\n"
     "  avail[o] = a;\n  potential[o] = p;\n  kq_split_mark(3);\n"
     "  kq_split_flush();\n}\n"),
]
AVAIL_WALK_SPLIT = [
    ("  const int c = static_cast<int>(i / t.F);\n",
     "  kq_split_start();\n  const int c = static_cast<int>(i / t.F);\n"),
    ("  avail[i] = a;\n  potential[i] = p;\n}\n",
     "  avail[i] = a;\n  potential[i] = p;\n  kq_split_mark(0);\n"
     "  kq_split_flush();\n}\n"),
]


def split_phase1(src: Path, dst: Path) -> tuple:
    """The phase timers in the checkout's kq_classify_heads and
    kq_cycle_order, whichever designs it has → (the classify is a group
    per head, the order has the registers route)."""
    text = (src / "solve_cycle.cu").read_text()
    group = "kq_group_ballot" in text
    chip = "kq_order_chip" in text
    pairs = [('#include "quota.cuh"\n',
              '#include "quota.cuh"\n' + SPLIT_HEAD.replace("TAG", "phase1")
              + "__shared__ volatile int kq_split_sink;\n")]
    if group:
        pairs += [
            ("  const bool live = w < k.W;\n",
             "  const bool live = w < k.W;\n  kq_split_start();\n"),
            ("    const bool fit = !notfit && !missing && slot_ok;\n",
             "    kq_split_mark(0);\n"
             "    const bool fit = !notfit && !missing && slot_ok;\n"),
            ("    if (stop_idx < 0 && m_stop != 0) {",
             "    kq_split_mark(1);\n"
             "    if (stop_idx < 0 && m_stop != 0) {"),
            ("      best_b = (m_bor >> i) & 1u;\n    }\n  }\n",
             "      best_b = (m_bor >> i) & 1u;\n    }\n"
             "    kq_split_mark(2);\n  }\n"),
            ("  if (k.dec_fr == nullptr) return;\n",
             "  if (k.dec_fr == nullptr) {\n    kq_split_mark(3);\n"
             "    kq_split_flush();\n    return;\n  }\n"),
            ("rel ? rq : 0;\n  }\n}\n",
             "rel ? rq : 0;\n  }\n  kq_split_mark(3);\n  kq_split_flush();\n"
             "}\n"),
        ]
    else:
        pairs += [
            ("  if (w >= k.W) return;\n",
             "  if (w >= k.W) return;\n  kq_split_start();\n"),
            ("  int stop_idx = -1, stop_mode = 0;\n",
             "  kq_split_mark(0);\n  int stop_idx = -1, stop_mode = 0;\n"),
            ("  const int chosen = stop_idx >= 0 ? stop_idx : best_idx;\n",
             "  kq_split_mark(1);\n"
             "  const int chosen = stop_idx >= 0 ? stop_idx : best_idx;\n"),
            ("  if (k.dec_fr == nullptr) return;\n",
             "  kq_split_mark(2);\n  if (k.dec_fr == nullptr) {\n"
             "    kq_split_flush();\n    return;\n  }\n"),
            ("  k.fit_mask[w] = has_fit;\n}\n",
             "  k.fit_mask[w] = has_fit;\n  kq_split_mark(3);\n"
             "  kq_split_flush();\n}\n"),
        ]
    pairs += ORDER_GLOBAL_SPLIT
    pairs += AVAIL_STAGED_SPLIT if "kq_avail_staged" in text \
        else AVAIL_WALK_SPLIT
    if chip:
        pairs += [
            ("  const unsigned full = 0xffffffffu;\n",
             "  const unsigned full = 0xffffffffu;\n  kq_split_start();\n"),
            ("  const int cross = 32 * E;",
             "  kq_split_mark(0);\n  const int cross = 32 * E;"),
            ("      unsigned long long* sh = order_smem + buf * P;\n",
             "      kq_split_mark(1);\n      kq_split_count(5);\n"
             "      unsigned long long* sh = order_smem + buf * P;\n"),
            ("      }\n    }\n    // partner in another lane of this warp",
             "      }\n      kq_split_mark(2);\n    }\n"
             "    // partner in another lane of this warp"),
            ("#pragma unroll\n  for (int r = 0; r < E; ++r) {\n"
             "    if (tid * E + r < W)",
             "  kq_split_mark(1);\n#pragma unroll\n"
             "  for (int r = 0; r < E; ++r) {\n    if (tid * E + r < W)"),
            ("static_cast<int>(lo[r] & 0x7fffffffu);\n    }\n  }\n}\n",
             "static_cast<int>(lo[r] & 0x7fffffffu);\n    }\n  }\n"
             "  kq_split_mark(3);\n  kq_split_flush();\n}\n"),
        ]
    (dst / "solve_cycle.cu").write_text(_patch(text, pairs, "solve_cycle.cu"))
    return group, chip


# kq_scatter_rows: the first warp of each block (the warp-per-pair design:
# the row and its values load together, one phase) or each plane-0 block
# (the block-per-pair design, whose P blocks of a row share its
# accumulator row: the row read with its range check, then the copy)
SCATTER_WARP_PHASES = {1: "row and values read + copy"}
SCATTER_BLOCK_PHASES = {0: "row read", 1: "copy loop"}


def split_scatter(src: Path, dst: Path) -> bool:
    """The phase timers in the checkout's kq_scatter_rows → (the
    warp-per-pair design)."""
    text = (src / "scatter_rows.cu").read_text()
    warp = "KQ_SCATTER_WARPS" in text
    head = SPLIT_HEAD.replace("TAG", "scatter")
    if warp:
        pairs = [
            ("#define KQ_SCATTER_WARPS 8\n",
             "#define KQ_SCATTER_WARPS 8\n" + head),
            ("  const int pair = blockIdx.x * KQ_SCATTER_WARPS",
             "  kq_split_start();\n"
             "  const int pair = blockIdx.x * KQ_SCATTER_WARPS"),
            ("      if (keep) dst[k] = v;\n    }\n  }\n}\n",
             "      if (keep) dst[k] = v;\n    }\n  }\n"
             "  kq_split_mark(1);\n  kq_split_flush();\n}\n"),
        ]
    else:
        pairs = [
            ("#define KQ_SCATTER_MAX_PLANES 16\n",
             "#define KQ_SCATTER_MAX_PLANES 16\n" + head),
            ("  const int i = blockIdx.x;\n  const int p = blockIdx.y;\n",
             "  kq_split_start();\n"
             "  const int i = blockIdx.x;\n  const int p = blockIdx.y;\n"),
            ("  if (r < 0 || r >= n_rows) return;\n",
             "  if (r < 0 || r >= n_rows) return;\n  kq_split_mark(0);\n"),
            ("dst[b] = src[b];\n  }\n}\n",
             "dst[b] = src[b];\n  }\n  kq_split_mark(1);\n"
             "  if (blockIdx.y == 0) kq_split_flush();\n}\n"),
        ]
    (dst / "scatter_rows.cu").write_text(_patch(text, pairs,
                                                "scatter_rows.cu"))
    return warp


# drs_components: block 0's thread 0 (lane 0 of its first warp)
DRS_LANE_PHASES = {0: "own cells (+ staging)", 1: "chain + level loads + fold",
                   2: "sums", 3: "stores"}
DRS_THREAD_PHASES = {0: "columns, parent chains, stores"}


def split_drs(src: Path, dst: Path) -> bool:
    """The phase timers in the checkout's drs_components → (the (node,
    column) design)."""
    text = (src / "drs_components.cu").read_text()
    lanes = "kq_drs_potential" in text
    pairs = [('#include "quota.cuh"\n',
              '#include "quota.cuh"\n' + SPLIT_HEAD.replace("TAG", "drs")
              + "__shared__ volatile unsigned kq_split_sink;\n")]
    if lanes:
        pairs += [
            ("  const int F = k.F, R = k.R, per = k.per;\n",
             "  const int F = k.F, R = k.R, per = k.per;\n"
             "  kq_split_start();\n"),
            ("  for (int c = 0; c < chunks; ++c) {\n",
             "  kq_split_mark(0);\n  for (int c = 0; c < chunks; ++c) {\n"),
            ("    // the (node, resource) sums:",
             "    if (threadIdx.x == 0) kq_split_sink = l;\n"
             "    kq_split_mark(1);\n    // the (node, resource) sums:"),
            ("      atomicAdd(acc + cells + key, l);\n    }\n"
             "    __syncwarp();\n  }\n",
             "      atomicAdd(acc + cells + key, l);\n    }\n"
             "    __syncwarp();\n    kq_split_mark(2);\n  }\n"),
            ("      k.lendable[o] = static_cast<int>(acc[cells + j]);\n"
             "    }\n  }\n}\n",
             "      k.lendable[o] = static_cast<int>(acc[cells + j]);\n"
             "    }\n  }\n  kq_split_mark(3);\n  kq_split_flush();\n}\n"),
        ]
    else:
        pairs += [
            ("  const int idx = blockIdx.x * blockDim.x + threadIdx.x;\n",
             "  kq_split_start();\n"
             "  const int idx = blockIdx.x * blockDim.x + threadIdx.x;\n"),
            ("  borrowing[idx] = b;\n  lendable[idx] = lend;\n}\n",
             "  borrowing[idx] = b;\n  lendable[idx] = lend;\n"
             "  kq_split_mark(0);\n  kq_split_flush();\n}\n"),
        ]
    (dst / "drs_components.cu").write_text(_patch(text, pairs,
                                                  "drs_components.cu"))
    return lanes


def split_sources(src: Path, dst: Path) -> tuple:
    """Copies of the checkout's kernel sources in ``dst``, with the
    phase timers in the flat admit_scan, burst_cycles and
    admit_scan_preempt → (the flat scan and burst are the
    forest-parallel designs, so is the preempt scan)."""
    dst.mkdir(parents=True, exist_ok=True)
    for f in src.iterdir():
        if f.suffix in (".cu", ".cuh"):
            (dst / f.name).write_text(f.read_text())
    if (src / "flat_forest.cuh").exists():
        split_shared_layout(src, dst)
        return True, True, split_search_forest(src, dst)
    if "retarget(" in (src / "burst_cycles.cu").read_text():
        split_forest_designs(src, dst)
        split_preempt_single(src, dst)
        return True, False, split_search_forest(src, dst)
    entry = (src / "admit_entry.cuh").read_text()
    body = entry[entry.index("__device__ __forceinline__ bool "
                             "kq_admit_entry("):]
    body = body.replace("kq_admit_entry(", "kq_admit_entry_split(", 1)
    body = _patch(body, [
        ("int wi, bool valid) {\n",
         "int wi, bool valid) {\n  kq_split_mark(1);\n"),
        ("f, avail)) ok_f = false;\n  }\n",
         "f, avail)) ok_f = false;\n  }\n  kq_split_mark(2);\n"),
        ("const bool ok = __syncthreads_and(ok_f) != 0;\n",
         "const bool ok = __syncthreads_and(ok_f) != 0;\n"
         "  kq_split_mark(3);\n"),
        ("  return admit;\n", "  kq_split_mark(4);\n  return admit;\n"),
    ], "admit_entry.cuh")
    flat_src = (src / "admit_scan.cu").read_text()
    flat_src = _patch(flat_src, [
        ('#include "admit_entry.cuh"\n',
         '#include "admit_entry.cuh"\n' + SPLIT_HEAD.replace("TAG", "admit")
         + body),
        ("  extern __shared__ int smem[];\n",
         "  extern __shared__ int smem[];\n  kq_split_start();\n"),
        ("  __syncthreads();\n  for (int i = 0; i < W; ++i) {\n",
         "  __syncthreads();\n  kq_split_mark(0);\n"
         "  for (int i = 0; i < W; ++i) {\n    kq_split_count(5);\n"),
        ("kq_admit_entry(t, c, usage, wi",
         "kq_admit_entry_split(t, c, usage, wi"),
        ("    if (threadIdx.x == 0) admitted[wi] = admit;\n  }\n}\n",
         "    if (threadIdx.x == 0) admitted[wi] = admit;\n  }\n"
         "  kq_split_flush();\n}\n"),
    ], "admit_scan.cu")
    (dst / "admit_scan.cu").write_text(flat_src)
    burst_src = (src / "burst_cycles.cu").read_text()
    burst_src = _patch(burst_src, [
        ('#include "quota.cuh"\n',
         '#include "quota.cuh"\n' + SPLIT_HEAD.replace("TAG", "burst")),
        ("  for (int w = tid; w < a.KCW; w += blockDim.x) used[w] = 0;\n"
         "  if (tid == 0) s_int[4] = 0;\n  __syncthreads();\n",
         "  for (int w = tid; w < a.KCW; w += blockDim.x) used[w] = 0;\n"
         "  if (tid == 0) s_int[4] = 0;\n  __syncthreads();\n"
         "  kq_split_mark(5);\n"),
        ("      a.u_tmp[o] = a.u_chk[o];\n    }\n    __syncthreads();\n",
         "      a.u_tmp[o] = a.u_chk[o];\n    }\n    __syncthreads();\n"
         "    kq_split_mark(5);\n"),
        ("    if (act) sub_targets(a, g, tw, a.u_tmp);\n"
         "    __syncthreads();\n    rebuild(a, g, a.u_tmp);\n",
         "    if (act) sub_targets(a, g, tw, a.u_tmp);\n"
         "    __syncthreads();\n    kq_split_mark(6);\n"
         "    rebuild(a, g, a.u_tmp);\n    kq_split_mark(7);\n"),
        ("      s_int[4] = 0;\n    }\n    __syncthreads();\n",
         "      s_int[4] = 0;\n    }\n    __syncthreads();\n"
         "    kq_split_mark(8);\n"),
        ("(overlap ? F_OVERLAP : 0);\n    }\n    __syncthreads();\n  }\n}\n",
         "(overlap ? F_OVERLAP : 0);\n    }\n    __syncthreads();\n"
         "    kq_split_mark(9);\n    kq_split_count(12);\n  }\n}\n"),
        ("  for (int k = 0; k < a.K; ++k) {\n    if (tid < 3)",
         "  kq_split_start();\n  for (int k = 0; k < a.K; ++k) {\n"
         "    if (tid < 3)"),
        ("    rebuild(a, g, a.u_cq);\n    heads(a, mem);\n"
         "    __syncthreads();\n    classify(a, t, mem, s_dflags);\n"
         "    __syncthreads();\n",
         "    kq_split_mark(11);\n    rebuild(a, g, a.u_cq);\n"
         "    kq_split_mark(0);\n    heads(a, mem);\n    __syncthreads();\n"
         "    kq_split_mark(1);\n    classify(a, t, mem, s_dflags);\n"
         "    __syncthreads();\n    kq_split_mark(2);\n"),
        ("      search_lane(a, g, c, k, mem, skey, sval, keep, s_int);\n",
         "      search_lane(a, g, c, k, mem, skey, sval, keep, s_int);\n"
         "      kq_split_count(13);\n"),
        ("    if (tid == 0) order(a, g, mem);\n    __syncthreads();\n"
         "    scan(a, t, g, k, mem, s_int);\n"
         "    transitions(a, g, k, mem, s_int);\n  }\n",
         "    kq_split_mark(3);\n    if (tid == 0) order(a, g, mem);\n"
         "    __syncthreads();\n    kq_split_mark(4);\n"
         "    scan(a, t, g, k, mem, s_int);\n"
         "    transitions(a, g, k, mem, s_int);\n    kq_split_mark(10);\n"
         "    kq_split_count(15);\n  }\n  kq_split_flush();\n"),
    ], "burst_cycles.cu")
    (dst / "burst_cycles.cu").write_text(burst_src)
    split_preempt_single(src, dst)
    return False, False, split_search_forest(src, dst)


def split_build(kernels, src: Path):
    """The instrumented library, built from ``src`` as ``kernels.build``
    builds the checkout's, loaded in its place."""
    import ctypes
    nvcc = kernels._nvcc()
    objs = [src / f"{Path(s).stem}.o" for s in kernels.SOURCES]

    def run(cmd):
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise SystemExit(f"--split build failed: {' '.join(cmd)}\n"
                             f"{r.stdout}\n{r.stderr}")
    with ThreadPoolExecutor(len(objs)) as ex:
        list(ex.map(run, [[nvcc, *kernels.NVCC_FLAGS, "-c", str(src / s),
                           "-o", str(o)] for s, o in zip(kernels.SOURCES,
                                                         objs)]))
    lib_path = src / "libkueue_kernels_split.so"
    run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o",
         str(lib_path), *map(str, objs)])
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in kernels._ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    for tag in ("admit", "burst", "preempt", "search", "forest", "phase1",
                "scatter", "drs"):
        getattr(lib, f"kq_split_{tag}_read").argtypes = [ctypes.c_void_p]
    kernels._lib = lib
    return lib


def split_run(lib, tag: str, call, names: dict, reps: int) -> dict:
    """Phase cycles of ``reps`` launches: block 0 and the block with the
    most cycles, per launch; µs at block 0's cycles per ns."""
    import ctypes
    import numpy as np
    import torch
    call()
    torch.cuda.synchronize()
    getattr(lib, f"kq_split_{tag}_reset")()
    for _ in range(reps):
        call()
    torch.cuda.synchronize()
    acc = np.zeros(1024 * 24, dtype=np.uint64)
    getattr(lib, f"kq_split_{tag}_read")(
        ctypes.c_void_p(acc.ctypes.data))
    acc = acc.reshape(1024, 24).astype(np.float64) / reps
    timed = [p for p, n in names.items() if not n.startswith("n ")]
    totals = acc[:, timed].sum(1)
    worst = int(totals.argmax())
    per_ns = totals[0] / max(acc[0, 14], 1.0)       # cycles per ns
    out = {"cycles_per_ns": per_ns, "blocks": int((totals > 0).sum()),
           "slowest_block": worst}
    for label, b in (("block0", 0), ("slowest", worst)):
        row = {}
        for p, n in names.items():
            v = acc[b, p]
            row[n] = v if n.startswith("n ") else dict(
                cycles=v, us=v / per_ns / 1e3,
                share=v / max(totals[b], 1.0))
        row["total_us"] = totals[b] / per_ns / 1e3
        out[label] = row
    return out


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    argv = sys.argv[1:]
    opts = {}
    for flag in ("--cases", "--split"):
        if flag in argv:
            i = argv.index(flag)
            opts[flag] = argv[i + 1]
            del argv[i:i + 2]
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    here = Path(__file__).resolve().parent
    sys.path.insert(0, os.path.abspath(argv[0]))
    from kueue_tpu_torch import kernels, scenarios
    from kueue_tpu_torch import testing as tt
    out = {"label": argv[1] if len(argv) > 1 else argv[0],
           "device": torch.cuda.get_device_name(0)}
    cases = load_cases(Path(opts.get(
        "--cases", here / ".kueue_tpu_torch_build" / "kernel_ab_cases.pt")))
    cases.update(synthetic_cases(tt))
    cases.update(phase1_cases(scenarios, tt))
    cases.update(avail_cases(scenarios, tt))
    cases.update(drs_cases(scenarios, tt))

    if "--split" in opts:
        dst = Path(opts["--split"]).resolve()
        forest, forest_pre, (search_warp, forest_flat) = split_sources(
            Path(kernels.__file__).resolve().parent, dst)
        group, chip = split_phase1(Path(kernels.__file__).resolve().parent,
                                   dst)
        warp = split_scatter(Path(kernels.__file__).resolve().parent, dst)
        lanes = split_drs(Path(kernels.__file__).resolve().parent, dst)
        staged = "kq_avail_staged" in (dst / "solve_cycle.cu").read_text()
        lib = split_build(kernels, dst)
        for case, call in drs_calls(kernels, cases):
            out[case] = split_run(lib, "drs", call, DRS_LANE_PHASES
                                  if lanes else DRS_THREAD_PHASES, 10)
            out[case]["design"] = ("lanes over (node, column)" if lanes
                                   else "thread per (node, resource)")
            out[case]["ms"] = event_ms(call, 10)
        for case, call in avail_calls(kernels, cases):
            out[case] = split_run(lib, "phase1", call, AVAIL_STAGED_PHASES
                                  if staged else AVAIL_WALK_PHASES, 10)
            out[case]["design"] = ("staged chain" if staged
                                   else "thread per cell, global walk")
            out[case]["route"] = kernels.PHASE1_ROUTES.get("kq_cq_avail")
            out[case]["ms"] = event_ms(call, 10)
        for case, call, _ in scatter_calls(kernels, cases):
            out[case] = split_run(lib, "scatter", call, SCATTER_WARP_PHASES
                                  if warp else SCATTER_BLOCK_PHASES, 10)
            out[case]["design"] = ("warp per (row, plane)" if warp
                                   else "block per (row, plane)")
            out[case]["ms"] = event_ms(call, 10)
        for case, call, _ in phase1_calls(kernels, cases):
            order = case.startswith("order")
            out[case] = split_run(lib, "phase1", call, ORDER_PHASES if order
                                  else CLASSIFY_GROUP_PHASES if group
                                  else CLASSIFY_THREAD_PHASES, 10)
            out[case]["design"] = (
                ("registers route" if chip else "one block in shared memory")
                if order else ("group per head" if group
                               else "thread per head"))
            out[case]["ms"] = event_ms(call, 10)
        for case, call in search_calls(kernels, cases):
            out[case] = split_run(lib, "search", call, SEARCH_PHASES, 10)
            out[case]["design"] = ("warp per search" if search_warp
                                   else "block per search")
            out[case]["ms"] = event_ms(call, 10)
        for case, call in forest_calls(kernels, cases):
            out[case] = split_run(lib, "forest", call, FOREST_FLAT_PHASES
                                  if forest_flat else FOREST_PHASES, 10)
            out[case]["design"] = ("flat_forest.cuh" if forest_flat
                                   else "block per forest")
            out[case]["ms"] = event_ms(call, 10)
        for case, call in preempt_calls(kernels, cases):
            out[case] = split_run(lib, "preempt", call, FOREST_PREEMPT_PHASES
                                  if forest_pre else PREEMPT_PHASES, 3)
            out[case]["ms"] = event_ms(call, 3)
        for case, call in admit_calls(kernels, cases):
            out[case] = split_run(lib, "admit", call,
                                  FLAT_PHASES if forest else ADMIT_PHASES,
                                  3 if case == "one_forest" else 10)
            out[case]["ms"] = event_ms(call, 10)
        for case, call in burst_calls(kernels, cases):
            reps = 2 if case == "burst_one_forest" else 10
            out[case] = split_run(lib, "burst", call, FOREST_BURST_PHASES
                                  if forest else BURST_PHASES, reps)
            out[case]["ms"] = event_ms(call, reps)
        print(json.dumps(out), flush=True)
        return 0

    out["library"] = str(kernels.build(force=True))
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()

    rng = np.random.default_rng(0)
    n = 4096
    leaf_free = np.stack([rng.choice([0, 32000, 64000], n),
                          rng.choice([0, 4, 8, 8], n),
                          rng.choice([16, 32], n)], 1).astype(np.int32)
    parents = (np.repeat(np.arange(8), 16), np.repeat(np.arange(128), 32))
    targs = (dev(leaf_free), dev(np.array([1000, 1, 1], np.int32)),
             tuple(dev(p.astype(np.int32)) for p in parents))
    sizes = (8, 128, 4096)
    for count in (40, 3000):
        for name, kw in (("best_fit_descend", dict(level=0)),
                         ("split_across_roots", {})):
            fn = getattr(kernels, name)

            def call():
                return fn(*targs, count, level_sizes=sizes,
                          profile="bestfit", **kw)
            out[f"{name}_{count}"] = dict(ms=event_ms(call, 50),
                                          digest=digest(*call()))

    shapes = {"fs_north_star": tt.FS_SHAPES[-1][:10],
              "fs_one_forest": None}
    for case, shape in shapes.items():
        if shape is None:
            c = tt.fs_cycle(np.random.default_rng(9), n_cqs=1000,
                            n_cohorts=200, depth=3, F=1, R=1, W=1024,
                            n_valid=1000, roots=1)
        else:
            n_cqs, n_coh, depth, F, R, W, n_valid, ties, w, zl = shape
            c = tt.fs_cycle(np.random.default_rng(0), n_cqs=n_cqs,
                            n_cohorts=n_coh, depth=depth, F=F, R=R, W=W,
                            n_valid=n_valid, ties=ties, weights=w,
                            zero_lend=zl)
        args = [dev(a) for a in tt.fs_args(c)]
        kw = dict(depth=c["depth"], n_levels=c["n_levels"])
        params = inspect.signature(kernels.fs_admit_scan).parameters
        if "n_forests" in params:
            fon = c["forest_of_node"]
            kw.update(n_forests=int(fon.max()) + 1,
                      max_forest=int(np.bincount(fon).max()))

        def call():
            return kernels.fs_admit_scan(*args, **kw)
        out[case] = dict(ms=event_ms(call, 10), digest=digest(*call()),
                         forests=int(c["forest_of_node"].max()) + 1)

    for case, call, lib in phase1_calls(kernels, cases):
        out[case] = dict(ms=event_ms(call, 20), digest=digest(*flat(call())))
        if lib is not None:
            out[case]["library_ms"] = event_ms(lib, 20)
    for case, call in avail_calls(kernels, cases):
        out[case] = dict(ms=event_ms(call, 50), digest=digest(*flat(call())),
                         route=kernels.PHASE1_ROUTES.get("kq_cq_avail"))
    for case, call, planes in scatter_calls(kernels, cases):
        out[case] = dict(ms=event_ms(call, 50), digest=digest(*planes))
    for case, call in drs_calls(kernels, cases):
        out[case] = dict(ms=event_ms(call, 50), digest=digest(*call()),
                         **own_us(call, "drs_components"),
                         route=getattr(kernels, "DRS_ROUTES", {}).get(
                             "drs_components"))
    out["resident_15c"] = resident_drain()
    for case, call in (search_calls(kernels, cases)
                       + forest_calls(kernels, cases)
                       + admit_calls(kernels, cases)
                       + burst_calls(kernels, cases)
                       + preempt_calls(kernels, cases)
                       + merge_calls(kernels, cases)):
        reps = 3 if case.endswith("one_forest") else 20
        out[case] = dict(ms=event_ms(call, reps),
                         digest=digest(*flat(call())))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
