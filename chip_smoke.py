#!/usr/bin/env python3
"""Smoke run of kueue_tpu_torch on one NVIDIA GPU.

Builds the CUDA kernels from the sources in this checkout, holds every
kernel against its plain PyTorch version, and drives the port's main path
at full size both ways: ``Driver(device="cuda").schedule_once`` per cycle
and ``Driver.schedule_burst``, K cycles per launch; then fair-sharing
admission, ``Driver(device="cuda", fair_sharing=True).schedule_once``;
then topology-aware scheduling, ``Driver(device="cuda")`` with the TAS
gates on; then the one-call cycle solver behind the north-star probe
(``python -m kueue_tpu_torch.probe``) and ``scenarios.entry()``, and
``Driver(solver_backend="native")``; then the forest-sharded burst and,
under ``KUEUE_TPU_SHARDS``, the per-cycle mesh; then the front door:
the reference perf harness (``python -m kueue_tpu_torch.perf.harness``)
and the job layer (Configuration, manifests, ``JobManager``):

1. device: name, count and ``nvidia-smi`` name/power limit;
2. build: nvcc of every kernel source (in parallel) into one library;
3. kernels: each CUDA kernel against its plain version on the CPU over a
   seeded sweep (kueue_tpu_torch.testing.kernel_cases, burst_cases,
   fs_cases and avail_cases: kq_cq_avail's staged route at depth 1, 2,
   3 and 17 and at N = 12,288, its global route at N = 13,000, both
   counted per call; admit_scan_preempt with the forest tables joined where a
   target lies in another forest, testing.preempt_tables) and over the
   inputs captured from the first calls of phases
   4, 5, 7, 8, 9 and 9b (for the burst also up to two windows with a
   preempting head) —
   exact equality (tolerance 0: every output is bool or int32, the
   burst's carry included);
4. the reference perf scenario: 5 cohorts x 6 CQs, 15,000 workloads in
   staggered waves, drained per cycle; all drained, preemptions > 0, no
   host-fallback cycle, and admit_scan, admit_scan_preempt and
   minimal_preemptions_batch launched;
5. the north-star shape: 1,000 CQs in cohorts of 5, 100,000 workloads,
   30 per-cycle cycles with a preemptor wave; admit_scan_forests launched;
6. card against CPU: the perf scenario at 3,000 workloads on "cuda" and
   on "cpu" must give the same decision digest;
7. the perf scenario drained through the fused burst: all 15,000
   drained with burst_cycles launched and cycles decided in bursts
   (dirty cycles by reason and per-cycle fallbacks printed); then at
   3,000 workloads on "cuda" and "cpu", equal decision digests;
8. the north-star shape through the fused burst at full width: 30
   cycles, the preemptor wave, burst_cycles launched, preemptions > 0;
9. fair sharing at the north-star size (scripts/northstar_e2e.py
   ``--fair-sharing``): 1,000 weighted CQs in cohorts of 5, 100,000
   workloads, 30 per-cycle cycles on the card; fs_admit_scan launched and
   cycles decided by it; then ``compute_all_drs`` on the final snapshot
   (drs_components launched) must equal the host DRS of every node,
   and again (9b) on two small clusters that borrow;
10. the same fair-sharing run on "cpu", at full size: its decision digest
   must equal the card's, and it launches no kernel;
11. tas-4k (kueue_tpu_torch.scenarios.build_tas): 8 blocks x 16
   subblocks x 32 hosts of 8 GPUs, 32 CQs in 4 cohorts, 6,400 gang
   workloads, 60 per-cycle cycles on the card; fill_counts,
   best_fit_descend and split_across_roots launched (once per call),
   every branch of TASFlavorSnapshot._find_device taken, the host tree
   walk never;
12. the same 60 cycles on "cpu" with the plain TAS programs, and with
   the host tree walk (TASDeviceKernel off): both digests, which cover
   every admission's topology domains and counts, equal the card's;
3e. the TAS kernels against their plain versions over a seeded sweep
   (kueue_tpu_torch.testing.tas_cases: every profile and Mixed's
   unconstrained variant, every request shape, 1-3 levels, a flat
   4,096-root level, levels shuffled out of id order and runs of 33-128
   children (both on the sort route), the working set and the sort in
   global memory) and the calls captured in phase 11 — exact in values
   and dtypes, with the route each walked level took counted;
13. the north-star probe at full size on the card
   (``kueue_tpu_torch.probe.run``): ``solve_cycle`` with
   ``run_scan=False`` over 100,000 heads x 1,000 CQs (S = 4, R = 3, 64
   cohorts), then ``solve_cycle`` over 1,000 heads and
   ``solve_cycle_forests`` over 64 forests, 20 timed calls each after a
   warm-up; p50 and worst, the kernels' per-call device ms, and the
   launches of kq_cq_avail, kq_classify_heads, kq_cycle_order, admit_scan
   and admit_scan_forests (one each per call that runs them: the sort
   only where the JAX program sorts, with the scan); every output equal
   to the plain versions on the card's host CPU;
3f. the three phase-1 kernels against their plain versions over a seeded
   sweep (kueue_tpu_torch.testing.solve_cycle_cases: N on both sides of
   64, padding, uncovered and invalid slots, int32 wraps, ties and
   INT_MIN, groups of 1 / 4 / 8 lanes a head (a lane a slot) and 40
   slots on the loop route, the order's registers route at 1 to 16,384
   heads and its global route past them), the classify forced onto its
   loop route (``kernels.CLASSIFY_LANES = 0``) and the sort into global
   scratch (``kernels.SORT_SMEM = 0``), and the calls captured in phase
   13 — exact; both routes of both kernels taken and counted per call
   (``kernels.PHASE1_ROUTES``; checked with the others' in 3h);
14. ``entry(device="cuda")``'s step equal to ``entry(device="cpu")``'s;
   then ``Driver(device="cuda", solver_backend="native")`` on the perf
   scenario at 3,000 workloads: its decision digest equal to phase 6's
   card digest, with cycles decided by the C++ admit loop;
3h. the shapes past the launchers' old limits
   (kueue_tpu_torch.testing.shape_cases): admit_scan,
   admit_scan_preempt, admit_scan_forests, minimal_preemptions_batch,
   burst_cycles, kq_cq_avail and drs_components on a cohort chain 17
   levels deep, fs_admit_scan at F = 65 and 72, kq_cq_avail on its
   global route (N = 13,000), admit_scan at F = 1,025,
   admit_scan_forests over one forest of 40,000 heads (its head list in
   global scratch) — each equal to its plain version; admit_scan over
   the flat scan's forest layouts (testing.flat_scan_cases: interleaved
   forests, padding, reserve heads, one forest, depth 17, F = 65, one
   forest past a block's shared memory, F = 1,025, F = 7,257 whose
   warps' column rows only global memory holds) with and without the
   forest tables, admit_scan_preempt over its forest layouts
   (testing.preempt_route_cases: cohorts of five, nested forests, depth
   17, F = 12, one forest, the cross-forest case under joined tables),
   admit_scan_forests over testing.FOREST_SHAPES (a forest with heads
   past max_forest_wl among them) and burst_cycles on a window and on
   one forest of every CQ, each with shared memory and with none allowed
   — both routes of the four kernels taken and counted per call; and
   minimal_preemptions_batch over testing.search_route_cases (S = 13 with
   padding searches between real ones, K = 1,024, F = 40, a tree past
   shared memory, candidates past it, both), each on the route its
   shapes give (``kernels.SEARCH_ROUTES``); then admit_scan over 1,000 heads
   timed on a cohort chain 17 levels deep beside the same heads on a
   chain of 2;
15. the north-star shape through the forest-sharded burst at full width
   (``KUEUE_TPU_SHARDS=4`` on a virtual mesh of four shards on this
   card, one stream each): the same 30 cycles as phase 8, whose decision
   digest it must equal; sharded dispatches > 0 and one
   kq_reduce_dflags launch for each (phases 8 and 15 start from a
   collected heap and print the full garbage collections that ran
   inside them);
15b. the sustained drain with a high-priority arrival at cycle 36 on 8
   virtual shards with ``KUEUE_TPU_RESIDENT_VERIFY=1``: records equal to
   the serial drain, resident hits > 0, rows scattered by
   kq_scatter_rows, fewer boundary bytes than a full upload; then the
   drain split in two with ``lose_devices(4)`` between the halves:
   8 → 4 shards and records equal to the serial split drain;
15c. the same drain at north-star width (scenarios.sustained_drain with
   n_cqs=1,000: 1,000 CQs in cohorts of 5, 100 workloads queued in every
   fifth, 40 reclaiming arrivals at cycle 36, runtime 30) on 4 virtual
   shards with ``KUEUE_TPU_RESIDENT_VERIFY=1``: records equal to the
   serial drain on the card, resident hits > 0 that scatter the busy
   CQs' rows with kq_scatter_rows, one packed host-to-device copy and
   one launch per shard with rows (``burst_resident_scatter_s`` and
   the copies per hit printed), fewer boundary bytes than a full
   upload;
3g. kq_scatter_rows and kq_reduce_dflags against their plain versions
   over seeded cases (kueue_tpu_torch.testing.scatter_case packed by
   ops.packing.pack_scatter_rows: padded duplicate rows, a row past the
   planes, 5-byte bool rows, 16-byte rows, every row of a 250-row
   shard; dflags_blocks) and the calls captured in phases 15, 15b and
   15c — exact;
16. the perf scenario through the per-cycle mesh (``KUEUE_TPU_SHARDS=4``
   on a virtual 2 x 2 mesh of this card: 5 forests on 2 cq shards, one
   stream per cell): all 15,000 drained, phase 4's decision digest,
   sharded and sharded preempt dispatches > 0, one kq_gather_heads
   launch per sharded dispatch, the per-shard launches of each kernel;
16b. the 30 north-star cycles through the mesh (``KUEUE_TPU_SHARDS=8``:
   4 x 2, 200 forests on 2 cq shards): phase 5's digest, the forest scan
   and the 1,000-gang preemption cycle sharded;
16c. the 30 fair-sharing north-star cycles through the mesh
   (``KUEUE_TPU_SHARDS=4``): phase 9's digest, sharded fs dispatches > 0,
   fs_admit_scan per shard, kq_fs_merge_order launched once per sharded
   fs dispatch;
16d. ``scenarios.dryrun_multichip(8)`` on a virtual 8-cell mesh of the
   card: every check of the JAX package's ``__graft_entry__
   .dryrun_multichip`` and its counts, with ``sharded_cycle_fn`` against
   the unsharded ``solve_cycle`` timed on the card;
17. the reference perf harness at full size: ``python -m
   kueue_tpu_torch.perf.harness perf/default_generator_config.yaml
   perf/default_rangespec.yaml`` as a child process (its maxrss and mCPU
   its own): 15,000 workloads finished, every class's average time to
   admission with large < medium < small, no rangespec failure on usage
   or time to admission (virtual time); wall, mCPU and maxrss printed
   beside their limits; then ``run_scenario`` on the config cut to 1
   cohort x 6 CQs (a fifth of each workload set) on "cuda" and "cpu":
   every virtual-time field of ``PerfStats`` equal, and admit_scan,
   admit_scan_preempt and minimal_preemptions_batch launched;
18. the job front door at tas-4k's size (``scenarios.build_jobs`` /
   ``run_jobs``): the Configuration from YAML (``config.load`` +
   ``validate``: the TAS gate on, waitForPodsReady, fair sharing off),
   ``Driver.from_config``, the cluster from one manifest
   (``api.manifests``: priority classes, the Topology, a GPU flavor on it
   and a CPU flavor, 4 cohorts, 32 ClusterQueues, LocalQueues) and
   4,096 GPU nodes, then 6,400 jobs of nine kinds (BatchJob, JobSet,
   PyTorchJob, MPIJob, RayJob, AppWrapper, PodGroup, StatefulSet,
   LeaderWorkerSet) in waves over 64 steps of ``JobManager`` syncs and
   ``schedule_once``, a high-priority wave at half time; every kind
   started, preempted jobs stopped with their templates restored, the
   webhook's refusals, fill_counts, best_fit_descend,
   split_across_roots, admit_scan and admit_scan_preempt launched, no
   full collection, and the same run on "cpu" with an equal digest (the
   feature gates restored after each);
3i. kq_gather_heads and kq_fs_merge_order against their plain versions
   on the calls captured in 16-16d and on one synthetic call each at
   north-star width (1,000 heads over 8 shards), and the per-shard admit
   scans and fs_admit_scan captured in 16-16c against theirs — exact;
3j. kq_reduce_dflags (the call captured in phase 15, and S = 8) and
   kq_gather_heads (the widest call captured in 16b, and 1,000 heads
   over 8 shards) taken apart: µs per call back to back of (a) the
   wrapper, (b) the bare C launch, (c) the library call, beside a
   one-element ``zero_()``, and the same calls under the profiler (each
   kernel's own duration and the start-to-start period).

Launch counts are zeroed just before phases 4, 5, 7, 8, 9, 9b, 11, 13,
14, 15, 15b, 15c, 16, 16b, 16c, 16d, 17 and 18 and read just after
each.  The
scenarios collect as the reference scripts do (builds frozen, drains
with collection off): the measured north-star phases 5, 8, 9, 15, 15c,
16b and 16c, tas-4k's phase 11 and the job front door's phase 18 must
see no full collection
(``GCWatch``), and
``scenarios.release()`` frees each phase's driver graph before the next
phase builds.  A
launch records no CUDA event: the device time of phases 4, 5, 7, 8, 9,
11, 13, 15, 15c, 16, 16b, 16c, 16d, 17 and 18 (per kernel, the rest, the busy union
and its share of the wall) comes from torch.profiler's CUDA activity
over the phase (``kueue_tpu_torch.profiling.DeviceClock``); a phase in
which it sees nothing fails.  Prints a ``kernels`` JSON line (per
kernel: its launches on its main path and in each phase, ms through
the wrapper, ``bare_ms`` of the C launch alone, ``kernel_ms`` by the
profiler, which must have recorded the timed launches (a kernel with
no profiler duration fails the run; 3k prints the host-to-device
offset of the profiler's clocks after the build and before the line);
the route of the timed call of each kernel with two; the TAS routes of the timed call, which must be the warp
route for best_fit_descend at tas-4k; the routes admit_scan and
burst_cycles took per call; a dependent-step count for the TAS
kernels, fs_admit_scan, admit_scan and burst_cycles; admit_scan also
on the probe's flat 1,000 heads, fs_admit_scan, admit_scan and
burst_cycles also on one forest of every CQ, their worst case), the
seconds by phase (``[walls]``, the wall up to each printed line summed
by the phase tag at its head) and the total, the
nvidia-smi line, and as its last line ``{"ok": true,
"device": {...}}``.  Exits non-zero, with no result line, when there is
no CUDA device or no kueue_tpu_torch beside it.

    python3 chip_smoke.py
"""

from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import time
from collections import Counter

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, and the float32 rate
# outside the tensor cores, used as the (generous) int32 rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
TPU_KERNEL = {   # the jitted JAX program each kernel replaces
    "admit_scan": "kueue_tpu/ops/cycle.py:251",
    "admit_scan_preempt": "kueue_tpu/ops/cycle.py:380",
    "admit_scan_forests": "kueue_tpu/ops/cycle.py:597",
    "minimal_preemptions_batch": "kueue_tpu/ops/preemption_kernel.py:135",
    "burst_cycles": "kueue_tpu/ops/burst.py:110",
    "fs_admit_scan": "kueue_tpu/ops/fs_scan.py:163",
    "drs_components": "kueue_tpu/ops/fairsharing_kernel.py:33",
    "fill_counts": "kueue_tpu/ops/tas_kernel.py:78",
    "best_fit_descend": "kueue_tpu/ops/tas_kernel.py:196",
    "split_across_roots": "kueue_tpu/ops/tas_kernel.py:219",
    "kq_cq_avail": "kueue_tpu/ops/cycle.py:458",
    "kq_classify_heads": "kueue_tpu/ops/cycle.py:463",
    "kq_cycle_order": "kueue_tpu/ops/cycle.py:521",
    "kq_scatter_rows": "kueue_tpu/ops/burst.py:2309",
    "kq_reduce_dflags": "kueue_tpu/ops/burst.py:789",
    "kq_gather_heads": "kueue_tpu/parallel/sharded.py:90",
    "kq_fs_merge_order": "kueue_tpu/parallel/sharded.py:137",
}
SOURCE = {
    "admit_scan": "kueue_tpu_torch/kernels/admit_scan.cu",
    "admit_scan_preempt": "kueue_tpu_torch/kernels/admit_scan_preempt.cu",
    "admit_scan_forests": "kueue_tpu_torch/kernels/admit_scan_forests.cu",
    "minimal_preemptions_batch":
        "kueue_tpu_torch/kernels/minimal_preemptions.cu",
    "burst_cycles": "kueue_tpu_torch/kernels/burst_cycles.cu",
    "fs_admit_scan": "kueue_tpu_torch/kernels/fs_admit_scan.cu",
    "drs_components": "kueue_tpu_torch/kernels/drs_components.cu",
    "fill_counts": "kueue_tpu_torch/kernels/tas_fill_counts.cu",
    "best_fit_descend": "kueue_tpu_torch/kernels/tas_descend.cu",
    "split_across_roots": "kueue_tpu_torch/kernels/tas_descend.cu",
    "kq_cq_avail": "kueue_tpu_torch/kernels/solve_cycle.cu",
    "kq_classify_heads": "kueue_tpu_torch/kernels/solve_cycle.cu",
    "kq_cycle_order": "kueue_tpu_torch/kernels/solve_cycle.cu",
    "kq_scatter_rows": "kueue_tpu_torch/kernels/scatter_rows.cu",
    "kq_reduce_dflags": "kueue_tpu_torch/kernels/scatter_rows.cu",
    "kq_gather_heads": "kueue_tpu_torch/kernels/mesh_gather.cu",
    "kq_fs_merge_order": "kueue_tpu_torch/kernels/mesh_gather.cu",
}
TAS_KERNELS = ("fill_counts", "best_fit_descend", "split_across_roots")
BENCH_WORKLOADS = 15_000
NORTHSTAR = dict(n_cqs=1000, n_wl=100_000, cycles=30)
KIND_PREEMPT = 4            # ops/burst.py decision code
PARITY_SCALE = 0.2          # 3,000 workloads
TAS_CYCLES = 60             # tas-4k, on the card, on the CPU and walked
PHASE1 = ("kq_cq_avail", "kq_classify_heads", "kq_cycle_order")
PROBE = dict(W=100_000, C=1_000, reps=20)   # scripts/northstar_probe.py
SHARD_KERNELS = ("kq_scatter_rows", "kq_reduce_dflags")
INPLACE = ("kq_scatter_rows",)   # writes its first argument's planes
NORTHSTAR_SHARDS = 4
RESIDENT_SHARDS = 8
MESH_KERNELS = ("kq_gather_heads", "kq_fs_merge_order")
MESH_SCANS = ("admit_scan", "admit_scan_forests", "admit_scan_preempt",
              "fs_admit_scan")
MESH_SHARDS = {"bench": 4, "northstar": 8, "fs": 4, "dryrun": 8}
ROUTED = ("admit_scan", "burst_cycles",   # kernels with two routes
          "admit_scan_preempt", "admit_scan_forests",
          "minimal_preemptions_batch", "kq_cq_avail", "kq_classify_heads",
          "kq_cycle_order")
# the routes each must take in 3f / 3h (minimal_preemptions_batch: its
# tree and its candidates each staged or global)
ROUTES_TAKEN = {"minimal_preemptions_batch": {
    "shared", "tree global", "candidates global", "global"},
    "kq_cq_avail": {"staged", "global"},
    "kq_classify_heads": {"group", "loop"},
    "kq_cycle_order": {"registers", "global"}}
HARNESS_TIMEOUT_S = 600    # phase 17's child process
README_REPLAY = ("76.8 virtual s; large/medium/small 0 / 33.2 / 54.1 s; "
                 "min CQ usage 98.7%")


PHASE_WALLS: dict[str, float] = {}   # wall s by phase, summed by ``log``
_LAST_LOG = [time.perf_counter()]


def log(msg: str) -> None:
    """Print one line.  The wall since the previous line counts to the
    phase named at the head of this one (``[11 tas-4k] ...`` → "11",
    ``[3h ...]`` → "3h"; a line without a tag → "-")."""
    now = time.perf_counter()
    tag = msg[1:].split("]")[0].split(" ")[0] if msg.startswith("[") else "-"
    PHASE_WALLS[tag] = PHASE_WALLS.get(tag, 0.0) + now - _LAST_LOG[0]
    _LAST_LOG[0] = now
    print(msg, flush=True)


def check(ok, what) -> None:
    """A phase's requirement; failing it fails the run."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


class Capture:
    """Wraps the solver's kernel entry points to keep the inputs of the
    first ``keep`` calls of each kernel in each phase (references, or
    copies for a kernel that writes its inputs: ``INPLACE``).  The
    wrapped function itself is called unchanged."""

    def __init__(self, keep: int = 4):
        self.keep = keep
        self.phase = ""
        self.calls: dict[tuple[str, str], list] = {}
        self._undo = []

    def install(self, module, attr: str, name: str) -> None:
        fn = getattr(module, attr)

        def wrapped(*args, **kw):
            calls = self.calls.setdefault((self.phase, name), [])
            args = tuple(tuple(a) if isinstance(a, list) else a
                         for a in args)
            kept = (clone_args(args) if name in INPLACE
                    and len(calls) < self.keep else args)
            out = fn(*args, **kw)
            if len(calls) < self.keep:
                calls.append((kept, kw))
            elif (name in PHASE1 and len(calls) < 2 * self.keep
                  and all(signature(a, k) != signature(args, kw)
                          for a, k in calls)):
                calls.append((args, kw))    # a call of another shape
            elif (name == "burst_cycles" and len(calls) < self.keep + 2
                  and bool((out[1] == KIND_PREEMPT).any())):
                calls.append((args, kw))    # a window with preemption
            return out

        setattr(module, attr, wrapped)
        self._undo.append((module, attr, fn))

    def uninstall(self) -> None:
        for module, attr, fn in reversed(self._undo):
            setattr(module, attr, fn)
        self._undo.clear()


class GCWatch:
    """Full (generation-2) garbage collections of the host's Python
    while a phase runs: how many, their seconds, the longest — a pause
    lands inside whichever cycle triggered it.  Entered inside the
    phase's ``DeviceClock``, so the profiler's own reading is not
    counted."""

    def __enter__(self):
        self.n, self.seconds, self.longest, self._t0 = 0, 0.0, 0.0, 0.0
        gc.callbacks.append(self._cb)
        return self

    def _cb(self, phase, info):
        if info.get("generation") != 2:
            return
        if phase == "start":
            self._t0 = time.perf_counter()
            return
        dt = time.perf_counter() - self._t0
        self.n += 1
        self.seconds += dt
        self.longest = max(self.longest, dt)

    def __exit__(self, *exc):
        gc.callbacks.remove(self._cb)

    def line(self) -> str:
        return (f"gen-2 GC {self.n} collections, {self.seconds:.3f}s, "
                f"longest {self.longest:.3f}s")


def clone_args(args):
    """Copies of a call's tensors (tuples of them included)."""
    return tuple(clone_args(a) if isinstance(a, tuple)
                 else a.clone() if hasattr(a, "clone") else a for a in args)


def install_shard_capture(cap: Capture) -> None:
    # the sharded burst looks these up in parallel.sharded at each call
    from kueue_tpu_torch.parallel import sharded
    cap.install(sharded, "scatter_rows", "kq_scatter_rows")
    cap.install(sharded, "reduce_dflags", "kq_reduce_dflags")


def install_mesh_capture(cap: Capture) -> None:
    # the mesh route looks its gather and merge up in parallel.sharded,
    # its per-shard scans in ops.cycle and ops.fs_scan, at each call
    from kueue_tpu_torch.ops import cycle, fs_scan
    from kueue_tpu_torch.parallel import sharded
    for name in MESH_KERNELS:
        cap.install(sharded, name[3:], name)
    for name in MESH_SCANS[:3]:
        cap.install(cycle, name, name)
    cap.install(fs_scan, "fs_admit_scan", "fs_admit_scan")


def signature(args, kw) -> tuple:
    """A call's shapes and keyword arguments."""
    return (tuple(tuple(a.shape) if hasattr(a, "shape") else a
                  for a in args), tuple(sorted(kw.items())))


def install_phase1_capture(cap: Capture) -> None:
    # solve_cycle looks its phase-1 functions up in ops.cycle at each call
    from kueue_tpu_torch.ops import cycle
    for name, attr in zip(PHASE1, ("cq_avail", "classify_heads",
                                   "cycle_order")):
        cap.install(cycle, attr, name)


def install_capture(cap: Capture) -> None:
    from kueue_tpu_torch.ops import preemption_solver, solver
    for name in ("admit_scan", "admit_scan_forests", "admit_scan_preempt"):
        cap.install(solver, name, name)
    cap.install(preemption_solver, "minimal_preemptions_batch",
                "minimal_preemptions_batch")
    from kueue_tpu_torch.ops import burst
    cap.install(burst, "burst_cycles", "burst_cycles")


def install_fs_capture(cap: Capture) -> None:
    # dispatch_fs imports fs_admit_scan from its module at each call and
    # compute_all_drs calls its module's drs_components
    from kueue_tpu_torch.ops import fairsharing_kernel, fs_scan
    cap.install(fs_scan, "fs_admit_scan", "fs_admit_scan")
    cap.install(fairsharing_kernel, "drs_components", "drs_components")


def install_tas_capture(cap: Capture) -> None:
    # TASFlavorSnapshot._find_device imports ops.tas_kernel at each query
    from kueue_tpu_torch.ops import tas_kernel
    for name in TAS_KERNELS:
        cap.install(tas_kernel, name, name)


def plain_fns():
    from kueue_tpu_torch.ops import (burst, cycle, fairsharing_kernel,
                                     fs_scan, preemption_kernel, tas_kernel)
    from kueue_tpu_torch.parallel import sharded
    return {
        "kq_scatter_rows": sharded.scatter_rows_plain,
        "kq_reduce_dflags": sharded.reduce_dflags_plain,
        "kq_gather_heads": sharded.gather_src_plain,
        "kq_fs_merge_order": sharded.fs_merge_order_plain,
        "fill_counts": tas_kernel.fill_counts_plain,
        "best_fit_descend": tas_kernel.best_fit_descend_plain,
        "split_across_roots": tas_kernel.split_across_roots_plain,
        "fs_admit_scan": fs_scan.fs_admit_scan_plain,
        "drs_components": fairsharing_kernel.drs_components_plain,
        "burst_cycles": burst.burst_cycles_plain,
        "admit_scan": cycle.admit_scan_plain,
        "admit_scan_forests": cycle.admit_scan_forests_plain,
        "admit_scan_preempt": cycle.admit_scan_preempt_plain,
        "minimal_preemptions_batch":
            preemption_kernel.minimal_preemptions_batch_plain,
        "kq_cq_avail": cycle.cq_avail_plain,
        "kq_classify_heads": cycle.classify_heads_plain,
        "kq_cycle_order": cycle.cycle_order_plain,
    }


def cuda_fns():
    from kueue_tpu_torch import kernels
    return {k: getattr(kernels, k) for k in kernels.KERNELS}


def as_tuple(x):
    """Outputs as a flat tuple of tensors (the burst's carry flattened)."""
    if not isinstance(x, tuple):
        return (x,)
    return tuple(t for y in x for t in as_tuple(y))


def on_cpu(args):
    return [tuple(on_cpu(a)) if isinstance(a, tuple)
            else a.cpu() if hasattr(a, "cpu") else a for a in args]


def on_card(args):
    """Seeded numpy inputs (tuples of arrays included) as CUDA tensors."""
    import numpy as np
    import torch
    return [tuple(on_card(a)) if isinstance(a, tuple)
            else torch.from_numpy(a).cuda() if isinstance(a, np.ndarray)
            else a for a in args]


def plain_kw(kw):
    return {k: v for k, v in kw.items()
            if k not in ("node_table", "device")}


def cuda_kw(kw):
    # without the caller's error word admit_scan_preempt reads its own
    return {k: v for k, v in kw.items() if k not in ("device", "error")}


def compare(name, args, kw, stats) -> None:
    """One CUDA launch against the plain version on CPU copies."""
    import torch
    if name in INPLACE:
        args = clone_args(args)
        plain = as_tuple(plain_fns()[name](*on_cpu(args), **plain_kw(kw)))
        cuda = as_tuple(cuda_fns()[name](*args, **cuda_kw(kw)))
    else:
        cuda = as_tuple(cuda_fns()[name](*args, **cuda_kw(kw)))
        plain = as_tuple(plain_fns()[name](*on_cpu(args), **plain_kw(kw)))
    torch.cuda.synchronize()
    if name in ROUTED:
        tally_route(name, stats)
    err = 0
    for c, p in zip(cuda, plain):
        check(c.dtype == p.dtype and c.shape == p.shape,
              f"{name}: {c.dtype}{tuple(c.shape)} vs "
              f"{p.dtype}{tuple(p.shape)}")
        d = (c.cpu().to(torch.int32) - p.to(torch.int32)).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
    s = stats[name]
    s["cases"] += 1
    s["mismatches"] += int(err != 0)
    s["max_abs_err"] = max(s["max_abs_err"], err)


def route_of(name) -> str:
    """The route the last launch of ``name`` took: kq_cq_avail's staged
    or global route, kq_classify_heads' lane groups or loop,
    kq_cycle_order's registers or global route; burst_cycles' forest
    state in shared memory or global rows; minimal_preemptions_batch's
    trees and candidates staged ("shared"), read from the inputs
    ("global"), or one of the two global; the blocks with heads of
    admit_scan, admit_scan_forests and admit_scan_preempt all on the
    shared-memory route, all on the global route, or both."""
    from kueue_tpu_torch import kernels
    if name in PHASE1:
        route = kernels.PHASE1_ROUTES[name]
    elif name == "burst_cycles":
        route = kernels.BURST_ROUTES[name]
    elif name == "minimal_preemptions_batch":
        r = kernels.SEARCH_ROUTES
        route = (r["tree"] if r["tree"] == r["candidates"]
                 else "tree global" if r["tree"] == "global"
                 else "candidates global")
    else:
        taken = {kernels.FLAT_ROUTE_NAMES[r]
                 for r in kernels.FLAT_ROUTES[name].cpu().tolist() if r}
        route = taken.pop() if len(taken) == 1 else (
            "both" if taken else "no heads")
    return route


def tally_route(name, stats) -> None:
    """The route of the last launch of ``name`` (``route_of``), counted
    per call in ``stats[name]["routes"]``."""
    route = route_of(name)
    routes = stats[name].setdefault("routes", {})
    routes[route] = routes.get(route, 0) + 1


def flat_dependent_steps(args, kw) -> int:
    """admit_scan's chain of dependent steps (kernels/admit_scan.cu):
    the prologue's passes over the nodes and heads (one load round per
    chunk of FLAT_THREADS x 4 items, a root walk of depth more without
    the forest tables), the staging's 3 barriers and the head
    compaction's 2 per chunk; then the largest forest's entries, each
    2 x depth + 3 (the pair loads, the walk, the vote, the column sums,
    the charge walk)."""
    import numpy as np
    from kueue_tpu_torch import kernels
    N = int(args[0].shape[0])
    W = int(args[8].shape[0])
    depth = kw["depth"]
    chunk = kernels.FLAT_THREADS * 4
    parent = args[5].cpu().numpy()
    root = np.arange(N)
    for _ in range(depth):
        root = np.where(parent[root] >= 0, parent[root], root)
    wl_cq = args[8].cpu().numpy()
    heads = np.bincount(root[wl_cq[wl_cq >= 0]], minlength=1)
    per_chunk = 1 + (0 if kw.get("forest_of_node") is not None else depth)
    n_chunks = -(-N // chunk) + -(-W // chunk)
    return (n_chunks * per_chunk + 3 + 2 * -(-W // chunk)
            + int(heads.max()) * (2 * depth + 3))


def burst_dependent_steps(kw) -> int:
    """burst_cycles' chain of dependent steps (kernels/burst_cycles.cu)
    per launch, the searches' candidate walks left out (they depend on
    the data): per cycle the rebuild's n_levels barriers and 12 more
    between the phases, then at most L scan entries on warp 0 of
    n_levels + 6 steps each (the overlap vote, the row refresh, the
    target removal, the marked rebuild's levels, the fit vote, the
    charge)."""
    n_levels = kw["n_levels"]
    return kw["K"] * (n_levels + 12 + kw["L"] * (n_levels + 6))


def io_bytes(args, outs) -> int:
    return sum(t.numel() * t.element_size()
               for t in as_tuple(tuple(args)) + as_tuple(tuple(outs))
               if hasattr(t, "numel"))


def tas_levels(name, kw) -> list:
    """The levels a TAS call sorts and walks (best_fit_descend: below
    the chosen level; split_across_roots: all, the roots as one
    segment)."""
    sizes = kw["level_sizes"]
    if name == "fill_counts":
        return []
    if name == "best_fit_descend":
        return list(range(kw["level"] + 1, len(sizes)))
    return list(range(len(sizes)))


def tas_op_count(name, args, kw) -> int:
    """int32 operations of a TAS call on its data: the fill (~4 per leaf
    and resource, ~2 per domain), then per level walked a comparison
    sort (~4 n log2 n) and a walk (~16 per child)."""
    import math
    sizes = kw["level_sizes"]
    ops = args[0].numel() * 4 + sum(sizes) * 2
    for d in tas_levels(name, kw):
        n = sizes[d]
        ops += int(4 * n * max(1.0, math.log2(n))) + 16 * n
    return ops


def tas_dependent_steps(name, args, kw, routes) -> int:
    """The launch's chain of dependent steps (kernels/tas.cuh): the route
    check's barrier and the fill's L - 1, two for the pick (the argmin,
    or the root total and the root split), then per level walked after
    it one on the warp route (``routes[d]`` 1), or on the sort route the
    bitonic sort's log2(P) (log2(P) + 1) / 2 barriers, three more and
    the level's longest child walk (three passes under BestFit)."""
    import numpy as np
    sizes = kw["level_sizes"]
    steps = len(sizes) + 2
    for d in tas_levels(name, kw):
        if routes[d] == 1:
            steps += 1 if d > 0 else 0     # the root split is the pick's
            continue
        lg = max(0, (sizes[d] - 1).bit_length())
        if d == 0:
            seg = sizes[0]
        else:
            par = args[2][d - 1].cpu().numpy()
            seg = int(np.bincount(par[(par >= 0) & (par < sizes[d - 1])],
                                  minlength=sizes[d - 1]).max())
        steps += lg * (lg + 1) // 2 + 3 + 3 * seg
    return steps


def fs_dependent_steps(args, kw) -> int:
    """The launch's chain of dependent steps (kernels/fs_admit_scan.cu):
    the membership sums (2 barriers), the two ordered compactions (2 per
    chunk of FS_STRIP x threads indices of N and of W) and the local
    maps (1); the largest forest's rounds, 5 + 7 (n_levels - 1) each;
    the finished-block count (2) and the last block's scan of W (2 per
    chunk)."""
    import numpy as np
    from kueue_tpu_torch import kernels
    N, F = args[0].shape
    W = int(args[12].shape[0])
    chunk = kernels.FS_STRIP * kernels.fs_threads(F, kw["max_forest"])
    wl_cq = args[12].cpu().numpy()
    valid = args[17].cpu().numpy()
    fon = args[18].cpu().numpy()
    k = np.bincount(fon[np.maximum(wl_cq, 0)][valid], minlength=1)
    rounds = int(k.max()) * (5 + 7 * (kw["n_levels"] - 1))
    return (2 + 2 * -(-N // chunk) + 2 * -(-W // chunk) + 1 + rounds + 2
            + 2 * -(-W // chunk))


def op_count(name, args, kw) -> int:
    """int32 operations the call's data needs: ~12 per column per chain
    step of each entry that runs (admit scans: valid heads' fit and
    charge walks; preempt: plus each preempting head's fit after removal
    and one removal walk per target it names; search: valid searches x
    real candidates x the forward and reverse steps)."""
    if name in TAS_KERNELS:
        return tas_op_count(name, args, kw)
    if name in ("kq_scatter_rows", "kq_gather_heads"):
        return 0                      # a copy: no arithmetic
    if name == "kq_fs_merge_order":
        # per head ~8 for its mark, suffix minimum and key, per emission
        # a binary search in each other shard's keys (~4 a step)
        n = [int(h.shape[0]) for h in args[1]]
        steps = max(n, default=0).bit_length()
        return sum(n) * (8 + 4 * (len(n) - 1) * steps)
    if name == "kq_reduce_dflags":
        return args[0].numel()                     # one add per input
    if name in PHASE1:
        return phase1_op_count(name, args, kw)
    depth = kw["depth"]
    if name == "fs_admit_scan":
        return fs_op_count(args, kw)
    if name == "drs_components":
        N, F = args[0].shape
        return int(N * F * (4 + depth * 12))
    if name == "burst_cycles":
        # per cycle: the heads' argmin and the end-of-cycle transitions
        # over every row, the classify over [C, S, R], and the forest
        # scan's chain walks (~12 ops per column per chain step)
        C, M, R = args[0].shape
        F = args[17].shape[1]
        return int(kw["K"] * (C * M * 8 + C * kw["S"] * R * depth * 12
                              + C * F * 2 * depth * 12 * 2))
    if name == "minimal_preemptions_batch":
        S, NL, F = args[0].shape
        valid = int((args[6] >= 0).sum())
        cands = int((args[9] >= 0).sum())
        per_search = cands / max(1, S)
        return int(valid * per_search * 2 * (2 * depth * F * 12))
    N, F = args[0].shape
    heads = int((args[8] >= 0).sum())
    ops = heads * 2 * depth * F * 12
    if name == "admit_scan_preempt":
        valid = args[8] >= 0
        pre = args[16] & valid
        targets = int(((args[19] >= 0) & pre[:, None]).sum())
        ops += (int(pre.sum()) + targets) * depth * F * 12
    return int(ops)


def phase1_op_count(name, args, kw) -> int:
    """int32 operations of a phase-1 call: ~10 per chain step of each
    (CQ, column) for both availabilities; ~16 per (head, slot, resource)
    and ~12 per (head, slot) of the classify, ~4 per pair written; the
    bitonic sort's log2(P) (log2(P) + 1) / 2 stages of P / 2
    compare-exchanges of ~8 operations, padded to P = 2^k >= W."""
    if name == "kq_cq_avail":
        F = args[0].shape[1]
        return int(kw["n_cqs"] * F * kw["depth"] * 2 * 10)
    if name == "kq_classify_heads":
        W = args[0].shape[0]
        _, S, R = args[3].shape
        return int(W * S * (R * 16 + 12) + (W * R * 4 if kw["pairs"] else 0))
    W = args[0].shape[0]
    lg = max(0, (W - 1).bit_length())
    return int(lg * (lg + 1) // 2 * (1 << lg) // 2 * 8 + W * 12)


def fs_forest_work(args):
    """(live rounds, entry-rounds, node-rounds) of an fs_admit_scan call
    on its data: every round removes one entry of its first remaining
    entry's forest, so a forest with k heads runs k rounds over k, k-1,
    ..., 1 remaining entries and its n nodes k times."""
    import numpy as np
    wl_cq = args[12].cpu().numpy()
    valid = args[17].cpu().numpy()
    fon = args[18].cpu().numpy()
    k = np.bincount(fon[np.maximum(wl_cq, 0)][valid],
                    minlength=int(fon.max()) + 1).astype(np.int64)
    n = np.bincount(fon, minlength=len(k)).astype(np.int64)
    return int(k.sum()), int((k * (k + 1) // 2).sum()), int((k * n).sum())


def fs_op_count(args, kw) -> int:
    """int32 operations of an fs_admit_scan call on its data: per
    entry-round the DRS walk (~8 per column and resource, ~16 per
    column and level), per node-round the five key passes of each
    tournament level (~8 each), per round the fit and charge walks."""
    N, F = args[0].shape
    R = args[9].shape[1]
    L, n_levels = kw["depth"], kw["n_levels"]
    rounds, entry_rounds, node_rounds = fs_forest_work(args)
    return int(entry_rounds * L * (8 * F * R + 16 * F)
               + node_rounds * (n_levels - 1) * 5 * 8
               + rounds * 2 * L * F * 12)


def bound_bytes(name, args, outs) -> int:
    """The bytes a call must move: each input read once, each output
    written once — for the in-place row scatter only the distinct rows
    it writes (2 x the distinct rows x the summed row bytes of its
    planes: one value read and one row written each; a padded duplicate
    row writes what its first copy wrote)."""
    import torch
    if name == "kq_scatter_rows":
        from kueue_tpu_torch.ops.packing import scatter_layout
        from kueue_tpu_torch.parallel import sharded
        planes, buf, count = args
        rows = sharded.unpack_scatter_rows(planes, buf, count)[0]
        rows = rows[(rows >= 0) & (rows < planes[0].shape[0])]
        return 2 * int(torch.unique(rows).numel()) * sum(
            scatter_layout(planes, count)[1])
    return io_bytes(args, outs)


def library_call(name, args):
    """The one PyTorch call that computes what the kernel computes on the
    same inputs (timed beside it, never used by the port), or None:
    ``index_put_`` per plane for the row scatter (one call per plane:
    PyTorch has no call that writes 13 tensors), ``torch.sum(dim=0)``
    over the flag window for the reduction, per plane ``index_copy_`` of
    the concatenated blocks into a filled row for the head gather (the
    maps read back from the source map and concatenated once, outside
    the timing), and for the cycle order a stable ``torch.argsort`` of
    the composed key (built once, outside the timing, as the gather's
    maps)."""
    import torch
    if name == "kq_scatter_rows":
        # the rows and values as views of the packed buffer
        from kueue_tpu_torch.parallel import sharded
        planes, buf, count = args
        rows, vals = sharded.unpack_scatter_rows(planes, buf, count)
        planes = clone_args(planes)
        idx = (rows.long(),)
        return lambda: [p.index_put_(idx, v) for p, v in zip(planes, vals)]
    if name == "kq_reduce_dflags":
        window = args[0]
        return lambda: torch.sum(window, dim=0, dtype=torch.int32)
    if name == "kq_gather_heads":
        from kueue_tpu_torch.parallel import sharded
        planes, src, fills = args
        idx = torch.cat(sharded.maps_of_source(
            src, [b.shape[0] for b in planes[0]])).long()
        outs = [torch.full((src.shape[0],), f, dtype=p[0].dtype,
                           device=src.device)
                for p, f in zip(planes, fills)]
        return lambda: [o.index_copy_(0, idx, torch.cat(p))
                        for o, p in zip(outs, planes)]
    if name == "kq_cycle_order":
        key = cycle_order_key(*args)
        return lambda: torch.argsort(key, stable=True)
    return None


def cycle_order_key(borrows0, priority, timestamp):
    """One int64 key whose stable ascending sort is the cycle order of
    ``ops.cycle.cycle_order_plain``: not borrowing first (the sign bit),
    then -priority (wrapping at INT_MIN, 32 bits), then the timestamp's
    dense rank in XLA's float order (31 bits)."""
    import torch
    from kueue_tpu_torch.ops.cycle import float32_sort_key
    neg = -priority.to(torch.int64)
    neg = torch.where(neg == 2**31, -2**31, neg)
    rank = torch.unique(float32_sort_key(timestamp), return_inverse=True)[1]
    base = torch.where(borrows0, 0, -2**63).to(torch.int64)
    return base + ((neg + 2**31) << 31) + rank.to(torch.int64)


def event_ms(fn, reps: int) -> float:
    """Mean device ms of ``fn`` over ``reps`` calls after three warm-up
    calls (CUDA events around the run)."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # hold the stream busy while the host enqueues every call, so the
    # events bracket the kernels back to back and not the host's
    # launch overhead between them
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def time_kernel(name, args, kw, reps: int = 50) -> dict:
    """Mean device ms per launch through the wrapper (CUDA events around
    ``reps`` launches queued behind a busy stream), the same for the bare
    C launch (``bare_launch``; None for burst_cycles, whose C launch
    advances its own carry), the kernel's own duration under the
    profiler (``profiled_period``), the plain version's ms on the same
    card-resident inputs (host clock, synchronized), the bound of the
    call (the larger of its bytes over HBM bandwidth and its int32
    operations over the peak rate) and the library call's ms."""
    import torch
    fn = cuda_fns()[name]
    kw_c = cuda_kw(kw)
    if name == "admit_scan_preempt":
        # an error word of the timing's own: no read-back per launch
        kw_c["error"] = torch.zeros(1, dtype=torch.int32,
                                    device=args[0].device)
    outs = as_tuple(fn(*args, **kw_c))

    def wrapper():
        return fn(*args, **kw_c)
    ms = event_ms(wrapper, reps)
    if name == "admit_scan_preempt":
        check(int(kw_c["error"].item()) == 0, f"{name}: error word set")
    bare_ms = (None if name == "burst_cycles"
               else event_ms(bare_launch(name, args, kw), reps))
    prof = profiled_period(wrapper, reps, name)
    require_kernel_time(name, prof, f"the kernels line's {name}")
    plain = plain_fns()[name]
    plain(*args, **plain_kw(kw))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain(*args, **plain_kw(kw))
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    bytes_ms = bound_bytes(name, args, outs) / PEAK_BYTES_PER_S * 1e3
    ops_ms = op_count(name, args, kw) / PEAK_OPS_PER_S * 1e3
    lib = library_call(name, args)
    if name == "kq_cycle_order":
        check(torch.equal(lib().to(torch.int32), outs[0]),
              "the composed-key argsort differs from kq_cycle_order")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                library_ms=event_ms(lib, reps) if lib is not None else None,
                bare_ms=bare_ms,
                kernel_ms=prof["kernel_us"] / 1e3,
                kernel_records=prof["kernel_records"])


def bare_launch(name, args, kw):
    """The kernel's C function as one wrapper call issues it, with the
    wrapper's checks, allocations and argument packing done once: a
    callable that re-issues only the C call on the current stream (and
    counts nowhere)."""
    import ctypes
    import torch
    from kueue_tpu_torch import kernels
    seen = []
    real = kernels._launch
    kernels._launch = lambda _name, fn, *a: seen.append((fn, a))
    try:
        outs = cuda_fns()[name](*args, **cuda_kw(kw))
    finally:
        kernels._launch = real
    check(len(seen) == 1, f"{name}: {len(seen)} launches in one call")
    fn, a = seen[0]
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def call():
        if fn(*a, stream) != 0:
            raise RuntimeError(f"{name}: bare launch failed")
        return outs
    return call


def profiled_period(fn, reps: int, name: str | None = None) -> dict:
    """``reps`` calls of ``fn`` queued behind a busy stream under the
    profiler's CUDA activity, in microseconds: per call the summed
    duration of the activities it issued and the start-to-start period
    of its first activity (``DeviceClock`` leaves the spins out), the
    mean duration of kernel ``name``'s own launches (``kernel_us``, None
    when the profiler recorded none of them), how many it recorded
    (``kernel_records``) and whether it recorded the 100 M-cycle spin
    (``spin_seen``: a spin longer than a millisecond).  A profiler that
    raises fails the run."""
    import torch
    from kueue_tpu_torch import kernels
    from kueue_tpu_torch.profiling import DeviceClock
    fn()
    torch.cuda.synchronize()
    with DeviceClock() as clk:
        torch.cuda._sleep(100_000_000)
        for _ in range(reps):
            fn()
    spans = sorted(s for v in clk.spans_us.values() for s in v)
    own = [t1 - t0 for n, v in clk.spans_us.items()
           if name is not None and kernels.launcher_of(n) == name
           for t0, t1 in v]
    out = dict(activities_per_call=len(spans) / reps,
               spin_seen=any(t1 - t0 > 1e3 for t0, t1 in clk.spin_us),
               kernel_records=len(own),
               kernel_us=sum(own) / len(own) if own else None)
    if not spans:
        return out
    per = max(1, round(len(spans) / reps))     # activities per call
    firsts = [spans[i][0] for i in range(0, len(spans), per)]
    return dict(
        out, device_us_per_call=sum(t1 - t0 for t0, t1 in spans) / reps,
        period_us=((firsts[-1] - firsts[0]) / (len(firsts) - 1)
                   if len(firsts) > 1 else None),
        names=sorted(clk.spans_us))


def require_kernel_time(name, prof, what: str) -> None:
    """A profiled run of ``name``'s kernel must give its own duration: a
    kernel that launched without one fails the run."""
    check(prof.get("kernel_us") is not None,
          f"{what}: the profiler recorded no launch of {name} "
          f"({json.dumps({k: prof.get(k) for k in ('kernel_records', 'activities_per_call', 'spin_seen', 'names')})})")


def profiler_clock_offset(reps: int = 20, margin_s: float = 1.0) -> dict:
    """Microseconds from the start of a host op (``aten::zero_``, the
    host's clock) to the start of its kernel (the device's timestamp as
    the profiler converts it), one-element zeroings on an idle card
    inside a window held open ``margin_s`` at each end: a few
    microseconds when the two clocks agree; its change over a run is the
    drift of the conversion (``DeviceClock.MARGIN_S`` must exceed it)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    x = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(margin_s)
        for _ in range(reps):
            x.zero_()
            torch.cuda.synchronize()
        time.sleep(margin_s)
    ev = prof.events()
    ops = sorted(e.time_range.start for e in ev if e.name == "aten::zero_"
                 and e.device_type == DeviceType.CPU)
    ks = sorted(e.time_range.start for e in ev
                if e.device_type == DeviceType.CUDA)
    off = sorted(k - o for o, k in zip(ops, ks))
    return dict(ops=len(ops), kernels=len(ks),
                median_us=off[len(off) // 2] if off else None,
                min_us=off[0] if off else None)


def launch_breakdown(cases, reps: int = 200) -> list:
    """Phase 3j: for each (label, kernel, args, kw), ms per call back to
    back behind a busy stream (``event_ms``) of (a) the wrapper, (b) the
    bare C launch and (c) the library call, beside a one-element
    ``zero_()`` (the floor of any launch); then the same launches under
    the profiler (``profiled_period``)."""
    import torch
    rows = []
    tiny = torch.zeros(1, dtype=torch.int32, device="cuda")
    for label, name, args, kw in cases:
        def wrapper():
            return cuda_fns()[name](*args, **cuda_kw(kw))
        calls = dict(wrapper=wrapper, bare=bare_launch(name, args, kw),
                     library=library_call(name, args), zero=tiny.zero_)
        row = dict(case=label, kernel=name)
        for mode, fn in calls.items():
            row[f"{mode}_ms"] = event_ms(fn, reps)
        for mode, fn in calls.items():
            row[f"{mode}_profiled"] = profiled_period(fn, reps, name)
            if mode in ("wrapper", "bare"):
                require_kernel_time(name, row[f"{mode}_profiled"],
                                    f"3j {label} ({mode})")
        rows.append(row)
    return rows


def host_drs(snapshot) -> dict:
    """cache.state.dominant_resource_share of every CQ and cohort."""
    from kueue_tpu_torch.cache.state import dominant_resource_share
    from kueue_tpu_torch.ops.packing import _iter_nodes
    cq_names, cohorts = _iter_nodes(snapshot)
    nodes = [snapshot.cluster_queues[n] for n in cq_names] + cohorts
    return {n.name: dominant_resource_share(n)[0] for n in nodes}


def most_heads(calls):
    """The captured fs_admit_scan call with the most valid heads."""
    return max(calls, key=lambda call: int(call[0][17].sum()))


def mesh_shape(name, args) -> dict:
    """W, shards and heads of a captured gather (planes, src, fills) or
    merge (winners, head_of, W) call."""
    if name == "kq_gather_heads":
        return dict(W=int(args[1].shape[0]), S=len(args[0][0]),
                    heads=int((args[1] >= 0).sum()))
    return dict(W=int(args[2]), S=len(args[1]),
                heads=int(sum(h.numel() for h in args[1])))


def widest_mesh(name, calls):
    """The captured gather or merge call over the most heads (its W),
    then the most shards."""
    return max(calls, key=lambda call: (mesh_shape(name, call[0])["W"],
                                        mesh_shape(name, call[0])["S"]))


def per_launch(dc, name) -> float:
    """A kernel's mean device ms over the launches the profiler recorded
    in a phase."""
    return dc.kernel_ms[name] / max(1, dc.kernel_count[name])


def device_line(tag, dc, wall_s: float, launches: dict) -> str:
    """A phase's device time from the profiler's CUDA activity
    (``profiling.DeviceClock``): each kernel's ms, every other
    activity's ms (the three largest by name), the busy union and its
    share of the phase's wall, and the launches the profiler did not
    record; the phase fails when the profiler saw nothing on the
    card."""
    from kueue_tpu_torch import kernels
    check(dc.activities > 0, f"phase {tag}: no device activity profiled")
    other = sorted(((sum(t1 - t0 for t0, t1 in v) / 1e3, n[:60])
                    for n, v in dc.spans_us.items()
                    if kernels.launcher_of(n) is None), reverse=True)[:3]
    missed = {k: launches[k] - dc.kernel_count[k] for k in launches
              if launches[k] != dc.kernel_count[k]}
    return (f"device (profiler) kernels_ms "
            f"{json.dumps({k: v for k, v in dc.kernel_ms.items() if v})}, "
            f"other {dc.other_ms:.3f}ms (largest "
            f"{json.dumps([[n, round(ms, 3)] for ms, n in other])}), busy "
            f"{dc.busy_ms:.3f}ms (busy share "
            f"{dc.busy_ms / 1e3 / wall_s:.6f}), {dc.activities} activities, "
            f"launches not recorded {json.dumps(missed)}")


def mesh_line(tag, d, r, launches, dc, digest, ref, wall_ref, gcw):
    from kueue_tpu_torch import scenarios
    ss = d.scheduler.solver.stats
    pct = scenarios.percentile
    keys = ("sharded_dispatches", "sharded_preempt_dispatches",
            "sharded_fs_dispatches", "sharded_empty_shards",
            "sharded_shard_launches", "full_cycles", "fs_full_cycles",
            "classify_cycles", "host_cycles", "skipped_dispatches",
            "singleton_dispatches")
    log(f"[{tag}] mesh {d.scheduler.solver.mesh.shape} (virtual, cuda:0), "
        f"{r['cycles']} cycles in {r['wall']:.2f}s (serial {wall_ref:.2f}s),"
        f" cycle p50 {pct(r['cycle_times'], 0.5) * 1e3:.3f}ms p99 "
        f"{pct(r['cycle_times'], 0.99) * 1e3:.3f}ms, mean "
        f"{r['wall'] / r['cycles'] * 1e3:.3f}ms, {gcw.line()}; digest "
        f"{digest} (serial {ref}); stats "
        f"{json.dumps({k: ss.get(k) for k in keys})}; launches "
        f"{json.dumps({k: v for k, v in launches.items() if v})}; "
        f"{device_line(tag, dc, r['wall'], launches)}")


def most_rows(calls):
    """The captured row scatter that writes the most rows."""
    return max(calls, key=lambda call: int(call[0][2]))


def largest(calls):
    """The captured call with the most heads (admit scans, [N, F] usage)
    or searches (the batched search, [S, NL, F] usage)."""
    def size(call):
        args = call[0]
        return args[0].shape[0] if args[0].dim() == 3 else args[8].shape[0]
    return max(calls, key=size)


def widest(calls):
    """The captured phase-1 call over the most heads (rows of its first
    argument)."""
    return max(calls, key=lambda call: call[0][0].shape[0])


def deepest(calls):
    """The captured best_fit_descend call that walks the most levels."""
    return min(calls, key=lambda call: call[1]["level"])


def burst_window(calls):
    """The captured burst window to time: the last one kept, which is a
    window with preemption whenever the phase had one."""
    return calls[-1]


def boundary_report(bstats: dict) -> str:
    """The harness's ``burst_boundary_report`` of ``BurstSolver.stats``,
    then the forest-sharded burst's two counters, under their stats
    names, where the run has them."""
    from kueue_tpu_torch.perf.harness import burst_boundary_report
    shard = {k: bstats[k] for k in ("burst_sharded_dispatches",
                                    "burst_shard_degradations")
             if k in bstats}
    return (json.dumps(burst_boundary_report(bstats))
            + (f" {json.dumps(shard)}" if shard else ""))


def burst_line(tag, d, r, launches) -> None:
    bs = d._burst_solver.stats
    ss = d.scheduler.solver.stats
    log(f"[{tag}] burst_cycles launches {launches['burst_cycles']}, "
        f"cycles decided {bs['burst_cycles_decided']}, dispatches "
        f"{bs['burst_dispatches']} (spec {bs['burst_spec_dispatches']}, "
        f"overlapped {bs['burst_overlapped_packs']}, cancelled "
        f"{bs['burst_spec_cancelled']}), preempt cycles in bursts "
        f"{bs['burst_preempt_cycles']}, dirty cycles "
        f"{bs['burst_dirty_cycles']} (preempt {bs['burst_dirty_preempt']}, "
        f"scalar {bs['burst_dirty_scalar']}), suppressed "
        f"{bs['burst_suppressed_cycles']}, target divergences "
        f"{bs['burst_target_divergences']}; per-cycle fallbacks: full "
        f"{ss['full_cycles']} classify {ss['classify_cycles']} host "
        f"{ss['host_cycles']}; boundary "
        f"{boundary_report(bs)}; launches "
        f"{json.dumps(launches)}")


class Launcher:
    """A small process, started before this one imports torch, that runs
    one command for it.  A child's ``ru_maxrss`` starts from the resident
    high-water mark of the process it was forked from (Linux carries it
    across exec), so a command started from here would report this run's
    gigabytes; started from the launcher it reports its own."""

    CODE = ("import json, subprocess, sys\n"
            "req = json.loads(sys.stdin.readline() or 'null')\n"
            "if req:\n"
            "    r = subprocess.run(req['cmd'], cwd=req['cwd'], "
            "env=req['env'], capture_output=True, text=True, "
            "timeout=req['timeout'])\n"
            "    sys.stdout.write(json.dumps([r.returncode, r.stdout, "
            "r.stderr]))\n")

    def __init__(self):
        self.proc = subprocess.Popen([sys.executable, "-c", self.CODE],
                                     stdin=subprocess.PIPE,
                                     stdout=subprocess.PIPE, text=True)

    def run(self, cmd: list, cwd: str, env: dict, timeout: float):
        """``subprocess.run(cmd, ...)`` in the launcher (killed after
        ``timeout`` seconds); the launcher exits afterwards."""
        out, _ = self.proc.communicate(json.dumps(dict(
            cmd=cmd, cwd=cwd, env=env, timeout=timeout)) + "\n",
            timeout=timeout + 60)
        rc, stdout, stderr = json.loads(out or "[null, \"\", \"\"]")
        return subprocess.CompletedProcess(cmd, rc, stdout, stderr)

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()


def main() -> int:
    launcher = Launcher()   # while this process is still small
    try:
        return smoke(launcher)
    finally:
        launcher.close()


def smoke(launcher: Launcher) -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import numpy as np
        from kueue_tpu_torch import kernels, scenarios, testing
        from kueue_tpu_torch.profiling import DeviceClock
    except ImportError as e:
        print(f"chip_smoke: kueue_tpu_torch not found beside the script "
              f"({e})", file=sys.stderr)
        return 3
    t_start = time.perf_counter()

    # -- 1. device --------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi: no output"
    log(f"[1 device] {kind} x{count}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    kernels.build(force=True)
    kernels.load()
    log(f"[2 build] {kernels.BUILD['library']} in "
        f"{time.perf_counter() - t0:.2f}s")
    clock_offset0 = profiler_clock_offset()

    # -- 3a. kernels against their plain versions: seeded sweep ------------
    stats = {k: dict(cases=0, mismatches=0, max_abs_err=0)
             for k in kernels.KERNELS}
    for seed in (0, 1):
        for name, arrays, kw in testing.kernel_cases(seed):
            args = [torch.from_numpy(a).cuda() for a in arrays]
            if name == "admit_scan_preempt":
                # the sweep's targets may lie in other forests
                fon, nf = testing.preempt_tables(arrays)
                kw = dict(kw, forest_of_node=torch.from_numpy(fon).cuda(),
                          n_forests=nf)
            compare(name, args, kw, stats)
        for _, arrays, kw in testing.burst_cases(seed):
            args = [torch.from_numpy(a).cuda() if isinstance(a, np.ndarray)
                    else int(a) for a in arrays]
            compare("burst_cycles", args, kw, stats)
        for name, arrays, kw in testing.fs_cases(seed):
            compare(name, [torch.from_numpy(a).cuda() for a in arrays], kw,
                    stats)
        # kq_cq_avail's staged route at depth 1, 2, 3 and 17 (N = 12,288,
        # the widest it stages, with seed 0) and its global route
        for name, arrays, kw in testing.avail_cases(seed, card=seed == 0):
            compare(name, on_card(arrays), kw, stats)
    log(f"[3 kernels, sweep] {json.dumps(stats)}")

    cap = Capture()
    install_capture(cap)

    # -- 4. the reference perf scenario, full size ---------------------------
    cap.phase = "bench"
    d, clock, total, waves = scenarios.build_bench(
        BENCH_WORKLOADS / 15_000, device="cuda")
    d.scheduler.solver.warmup(d.cache.snapshot(),
                              len(d.cache.cluster_queue_names()))
    kernels.reset_counts()
    with DeviceClock() as dc4:
        r = scenarios.run_bench(d, clock, total, waves)
    launches4 = dict(kernels.LAUNCHES)
    ss = d.scheduler.solver.stats
    aps = r["finished"] / r["wall"]
    log(f"[4 bench] drained {r['finished']}/{r['total']} in "
        f"{r['cycles']} cycles, {r['wall']:.2f}s wall, {aps:.1f} "
        f"admissions/s, cycle p50 "
        f"{scenarios.percentile(r['cycle_times'], 0.5) * 1e3:.3f}ms p99 "
        f"{scenarios.percentile(r['cycle_times'], 0.99) * 1e3:.3f}ms, "
        f"preempted {r['preempted']}, full_cycles {ss['full_cycles']}, "
        f"host_cycles {ss['host_cycles']}, classify_cycles "
        f"{ss['classify_cycles']}; launches {json.dumps(launches4)}; "
        f"{device_line('4', dc4, r['wall'], launches4)}")
    digest4 = scenarios.decision_digest(d, r["decisions"])
    wall4 = r["wall"]
    log(f"[4 bench] digest {digest4}")
    check(r["finished"] == r["total"] == BENCH_WORKLOADS, r["finished"])
    check(r["preempted"] > 0, "no preemption in the perf scenario")
    check(ss["host_cycles"] == 0, ss)
    for k in ("admit_scan", "admit_scan_preempt",
              "minimal_preemptions_batch"):
        check(launches4[k] > 0, (k, launches4))
    del d, waves
    scenarios.release()

    # -- 5. the north-star shape, per cycle ---------------------------------
    cap.phase = "northstar"
    t0 = time.perf_counter()
    d, clock, total, wave = scenarios.build_northstar(
        NORTHSTAR["n_cqs"], NORTHSTAR["n_wl"], device="cuda")
    d.scheduler.solver.warmup(d.cache.snapshot(), NORTHSTAR["n_cqs"])
    build_s = time.perf_counter() - t0
    kernels.reset_counts()
    with DeviceClock() as dc5, GCWatch() as gc5:
        r5 = scenarios.run_northstar(d, clock, wave,
                                     cycles=NORTHSTAR["cycles"])
    launches5 = dict(kernels.LAUNCHES)
    log(f"[5 northstar] {NORTHSTAR['n_cqs']} CQs, {total} workloads "
        f"(built in {build_s:.1f}s), {r5['cycles']} cycles in "
        f"{r5['wall']:.2f}s, cycle p50 "
        f"{scenarios.percentile(r5['cycle_times'], 0.5) * 1e3:.3f}ms p99 "
        f"{scenarios.percentile(r5['cycle_times'], 0.99) * 1e3:.3f}ms, "
        f"admitted {r5['admitted']}, preempted {r5['preempted']}; "
        f"{gc5.line()}; launches {json.dumps(launches5)}; "
        f"{device_line('5', dc5, r5['wall'], launches5)}")
    digest5 = scenarios.decision_digest(d, r5["decisions"])
    log(f"[5 northstar] digest {digest5}")
    check(launches5["admit_scan_forests"] > 0, launches5)
    check(gc5.n == 0, f"phase 5: {gc5.line()}")
    del d
    scenarios.release()
    cap.uninstall()

    # -- 3b. kernels against their plain versions: captured planes ----------
    for (_, name), calls in cap.calls.items():
        for args, kw in calls:
            compare(name, args, kw, stats)
    for name, s in stats.items():
        check(s["mismatches"] == 0, (name, s))
    log(f"[3 kernels, captured] {json.dumps(stats)}")

    # -- 6. card against CPU -----------------------------------------------
    digests = {}
    for dev in ("cuda", "cpu"):
        d, clock, total, waves = scenarios.build_bench(PARITY_SCALE,
                                                       device=dev)
        r6 = scenarios.run_bench(d, clock, total, waves)
        digests[dev] = scenarios.decision_digest(d, r6["decisions"])
        log(f"[6 parity] {dev}: {r6['finished']}/{total} drained, "
            f"{r6['preempted']} preempted, digest {digests[dev]}")
        check(r6["finished"] == total, f"{dev}: not drained")
        del d
        scenarios.release()
    check(digests["cuda"] == digests["cpu"], digests)
    digest6 = digests["cuda"]

    # -- 7. the perf scenario through the fused burst -------------------------
    install_capture(cap)
    cap.phase = "bench_burst"
    d, clock, total, waves = scenarios.build_bench(
        BENCH_WORKLOADS / 15_000, device="cuda")
    d.scheduler.solver.warmup(d.cache.snapshot(),
                              len(d.cache.cluster_queue_names()))
    kernels.reset_counts()
    with DeviceClock() as dc7:
        r7 = scenarios.drain_bench_burst(d, clock, total, waves)
    launches7 = dict(kernels.LAUNCHES)
    log(f"[7 bench burst] drained {r7['finished']}/{r7['total']} in "
        f"{r7['cycles']} cycles, {r7['wall']:.2f}s wall, "
        f"{r7['finished'] / r7['wall']:.1f} admissions/s, cycle p50 "
        f"{scenarios.percentile(r7['cycle_times'], 0.5) * 1e3:.3f}ms p99 "
        f"{scenarios.percentile(r7['cycle_times'], 0.99) * 1e3:.3f}ms, "
        f"preempted {r7['preempted']}, digest "
        f"{scenarios.decision_digest(d, r7['decisions'])}; "
        f"{device_line('7', dc7, r7['wall'], launches7)}")
    burst_line("7 bench burst", d, r7, launches7)
    check(r7["finished"] == r7["total"] == BENCH_WORKLOADS, r7["finished"])
    check(launches7["burst_cycles"] > 0, launches7)
    check(d._burst_solver.stats["burst_cycles_decided"] > 0, "no burst")
    del d, waves
    scenarios.release()
    cap.uninstall()

    # -- 7b. the burst on the card against the CPU --------------------------
    digests = {}
    for dev in ("cuda", "cpu"):
        d, clock, total, waves = scenarios.build_bench(PARITY_SCALE,
                                                       device=dev)
        r = scenarios.drain_bench_burst(d, clock, total, waves)
        digests[dev] = scenarios.decision_digest(d, r["decisions"])
        log(f"[7 burst parity] {dev}: {r['finished']}/{total} drained, "
            f"{r['preempted']} preempted, "
            f"{d._burst_solver.stats['burst_cycles_decided']} cycles "
            f"decided in bursts, digest {digests[dev]}")
        check(r["finished"] == total, f"{dev}: not drained")
        del d
        scenarios.release()
    check(digests["cuda"] == digests["cpu"], digests)

    # -- 8. the north-star shape through the fused burst ---------------------
    install_capture(cap)
    cap.phase = "northstar_burst"
    t0 = time.perf_counter()
    d, clock, total, wave = scenarios.build_northstar(
        NORTHSTAR["n_cqs"], NORTHSTAR["n_wl"], device="cuda")
    d.scheduler.solver.warmup(d.cache.snapshot(), NORTHSTAR["n_cqs"])
    build_s = time.perf_counter() - t0
    gc.collect()      # phases 8 and 15 start from a collected heap
    kernels.reset_counts()
    with DeviceClock() as dc8, GCWatch() as gc8:
        r8 = scenarios.northstar_burst(d, clock, wave,
                                       cycles=NORTHSTAR["cycles"])
    launches8 = dict(kernels.LAUNCHES)
    digest8 = scenarios.decision_digest(d, r8["decisions"])
    log(f"[8 northstar burst] {NORTHSTAR['n_cqs']} CQs, {total} workloads "
        f"(built in {build_s:.1f}s), {r8['cycles']} cycles in "
        f"{r8['wall']:.2f}s, cycle p50 "
        f"{scenarios.percentile(r8['cycle_times'], 0.5) * 1e3:.3f}ms p99 "
        f"{scenarios.percentile(r8['cycle_times'], 0.99) * 1e3:.3f}ms, "
        f"admitted {r8['admitted']}, preempted {r8['preempted']}, digest "
        f"{digest8}; {gc8.line()}; "
        f"{device_line('8', dc8, r8['wall'], launches8)}")
    burst_line("8 northstar burst", d, r8, launches8)
    check(r8["cycles"] == NORTHSTAR["cycles"], r8["cycles"])
    check(launches8["burst_cycles"] > 0, launches8)
    check(r8["preempted"] > 0, "no preemption in the north-star wave")
    check(gc8.n == 0, f"phase 8: {gc8.line()}")
    del d
    scenarios.release()
    cap.uninstall()

    # -- 3c. the burst kernel on the windows captured in phases 7 and 8 ------
    n_pre = 0
    for phase in ("bench_burst", "northstar_burst"):
        for name in kernels.KERNELS:
            for args, kw in cap.calls.get((phase, name), []):
                compare(name, args, kw, stats)
                if name == "burst_cycles":
                    out = plain_fns()[name](*on_cpu(args), **plain_kw(kw))
                    n_pre += int(bool((out[1] == KIND_PREEMPT).any()))
    for name, s in stats.items():
        check(s["mismatches"] == 0, (name, s))
    check(n_pre > 0, "no captured burst window with a preempting head")
    log(f"[3 kernels, captured bursts] {n_pre} windows with preemption; "
        f"{json.dumps(stats)}")

    # -- 9. fair sharing at the north-star size, on the card ------------------
    from kueue_tpu_torch.ops.fairsharing_kernel import compute_all_drs
    install_fs_capture(cap)
    cap.phase = "northstar_fs"
    t0 = time.perf_counter()
    d, clock, total = scenarios.build_northstar_fs(
        NORTHSTAR["n_cqs"], NORTHSTAR["n_wl"], device="cuda")
    d.scheduler.solver.warmup(d.cache.snapshot(), NORTHSTAR["n_cqs"])
    build_s = time.perf_counter() - t0
    kernels.reset_counts()
    with DeviceClock() as dc9:
        with GCWatch() as gc9:
            r9 = scenarios.run_northstar_fs(d, clock,
                                            cycles=NORTHSTAR["cycles"])
        snapshot = d.cache.snapshot()
        t_drs = time.perf_counter()
        drs = compute_all_drs(snapshot, device="cuda")
        drs_s = time.perf_counter() - t_drs
    launches9 = dict(kernels.LAUNCHES)
    ss = d.scheduler.solver.stats
    digest9 = scenarios.decision_digest(d, r9["decisions"])
    log(f"[9 northstar fs] {NORTHSTAR['n_cqs']} CQs, {total} workloads "
        f"(built in {build_s:.1f}s), {r9['cycles']} cycles in "
        f"{r9['wall']:.2f}s, cycle p50 "
        f"{scenarios.percentile(r9['cycle_times'], 0.5) * 1e3:.3f}ms p99 "
        f"{scenarios.percentile(r9['cycle_times'], 0.99) * 1e3:.3f}ms, "
        f"admitted {r9['admitted']}, skipped {r9['skipped']}, "
        f"fs_full_cycles {ss['fs_full_cycles']}, fs_noop_skips "
        f"{ss['fs_noop_skips']}, fs_noop_reuses {ss['fs_noop_reuses']}, "
        f"classify_cycles {ss['classify_cycles']}, host_cycles "
        f"{ss['host_cycles']}; digest {digest9}; {gc9.line()}; launches "
        f"{json.dumps(launches9)}; "
        f"{device_line('9', dc9, r9['wall'], launches9)}")
    check(launches9["fs_admit_scan"] > 0, launches9)
    check(gc9.n == 0, f"phase 9: {gc9.line()}")
    check(ss["fs_full_cycles"] > 0, ss)
    check(r9["admitted"] > 0, "nothing admitted")
    host = host_drs(snapshot)
    log(f"[9 compute_all_drs] {len(drs)} nodes in {drs_s * 1e3:.3f}ms, "
        f"{sum(v > 0 for v in host.values())} borrowing, equal to the "
        f"host: {drs == host}")
    check(drs == host, "compute_all_drs differs from the host DRS")
    check(launches9["drs_components"] > 0, launches9)
    del d, snapshot
    scenarios.release()

    # -- 9b. compute_all_drs on a cluster that borrows ----------------------
    # (the north-star CQs fill their cohort's quota and never borrow)
    from kueue_tpu_torch.api import types as api_types
    from kueue_tpu_torch.controller.driver import Driver
    cap.phase = "fs_borrowing"
    kernels.reset_counts()
    for nested in (False, True):
        clock = scenarios.VirtualClock()
        d = Driver(clock=clock, fair_sharing=True, device="cuda")
        testing.fs_borrowing_cluster(api_types, d, clock, nested)
        snapshot = d.cache.snapshot()
        drs = compute_all_drs(snapshot, device="cuda")
        host = host_drs(snapshot)
        n_borrow = sum(v > 0 for v in host.values())
        log(f"[9b compute_all_drs] nested={nested}: {len(drs)} nodes, "
            f"{n_borrow} borrowing, DRS {sorted(host.values())}, equal to "
            f"the host: {drs == host}")
        check(drs == host, "compute_all_drs differs from the host DRS")
        check(n_borrow > 0, "no borrowing node")
    torch.cuda.synchronize()
    launches9b = dict(kernels.LAUNCHES)
    check(launches9b["drs_components"] == 2, launches9b)
    cap.uninstall()

    # -- 10. the same fair-sharing run on the CPU ------------------------------
    before = dict(kernels.LAUNCHES)
    d, clock, total = scenarios.build_northstar_fs(
        NORTHSTAR["n_cqs"], NORTHSTAR["n_wl"], device="cpu")
    r10 = scenarios.run_northstar_fs(d, clock, cycles=NORTHSTAR["cycles"])
    digest10 = scenarios.decision_digest(d, r10["decisions"])
    log(f"[10 fs parity] cpu: {total} workloads, {r10['cycles']} cycles in "
        f"{r10['wall']:.2f}s, admitted {r10['admitted']}, skipped "
        f"{r10['skipped']}, fs_full_cycles "
        f"{d.scheduler.solver.stats['fs_full_cycles']}, digest {digest10}")
    check(digest10 == digest9, {"cuda": digest9, "cpu": digest10})
    check(kernels.LAUNCHES == before, "the CPU run launched a kernel")
    del d
    scenarios.release()

    # -- 3d. the fair-sharing kernels on the calls captured in 9 and 9b ------
    for name in ("fs_admit_scan", "drs_components"):
        for phase in ("northstar_fs", "fs_borrowing"):
            for args, kw in cap.calls.get((phase, name), []):
                compare(name, args, kw, stats)
    for name, s in stats.items():
        check(s["mismatches"] == 0, (name, s))
    log(f"[3 kernels, captured fair sharing] {json.dumps(stats)}")

    # -- 11. topology-aware scheduling at tas-4k, on the card -----------------
    install_tas_capture(cap)
    cap.phase = "tas"
    with scenarios.tas_gates():
        t0 = time.perf_counter()
        d, clock, runtimes = scenarios.build_tas(device="cuda")
        build_s = time.perf_counter() - t0
        kernels.reset_counts()
        with (scenarios.TASBranches() as br11, DeviceClock() as dc11,
              GCWatch() as gc11):
            r11 = scenarios.run_tas(d, clock, runtimes, cycles=TAS_CYCLES)
        launches11 = dict(kernels.LAUNCHES)
    cap.uninstall()
    digest11 = scenarios.tas_digest(d, r11)
    ss = d.scheduler.solver.stats
    wall11 = sum(r11["cycle_times"])
    dev11 = dc11.busy_ms / 1e3
    log(f"[11 tas-4k] {len(d.cache.tas.nodes)} nodes, {len(runtimes)} "
        f"workloads (built in {build_s:.1f}s), {r11['cycles']} cycles in "
        f"{r11['wall']:.2f}s, cycle p50 "
        f"{scenarios.percentile(r11['cycle_times'], 0.5) * 1e3:.3f}ms p99 "
        f"{scenarios.percentile(r11['cycle_times'], 0.99) * 1e3:.3f}ms, "
        f"admitted {r11['admitted']}; branches {json.dumps(br11.counts)}; "
        f"full_cycles {ss['full_cycles']}, scalar_heads "
        f"{ss['scalar_heads']}, host_cycles {ss['host_cycles']}; device "
        f"busy {dev11 * 1e3:.3f}ms of {wall11 * 1e3:.3f}ms cycle wall (host "
        f"share {1 - dev11 / wall11:.4f}); digest {digest11}; "
        f"{gc11.line()}; launches "
        f"{json.dumps(launches11)}; "
        f"{device_line('11', dc11, r11['wall'], launches11)}")
    check(r11["admitted"] > 0, "tas-4k admitted nothing")
    for name in TAS_KERNELS:
        check(launches11[name] > 0, (name, launches11))
        check(launches11[name] == br11.counts[name],
              (name, "launches differ from calls", launches11, br11.counts))
    for branch in scenarios.TASBranches.BRANCHES:
        check(br11.counts[branch] > 0, (branch, br11.counts))
    check(br11.counts["scalar_walk"] == 0, "the host walk ran on the card")
    check(launches11["admit_scan"] > 0, launches11)
    check(gc11.n == 0, f"phase 11: {gc11.line()}")
    del d
    scenarios.release()

    # -- 12. the same cycles on the CPU: plain programs, then the host walk --
    before = dict(kernels.LAUNCHES)
    for label, device_kernel in (("plain", True), ("host walk", False)):
        with scenarios.tas_gates(device_kernel=device_kernel):
            d, clock, runtimes = scenarios.build_tas(device="cpu")
            with scenarios.TASBranches() as br:
                r = scenarios.run_tas(d, clock, runtimes, cycles=TAS_CYCLES)
        digest = scenarios.tas_digest(d, r)
        log(f"[12 tas parity] cpu, {label}: {r['cycles']} cycles in "
            f"{r['wall']:.2f}s, admitted {r['admitted']}, calls "
            f"{json.dumps({k: br.counts[k] for k in br.CALLS})}, digest "
            f"{digest}")
        check(digest == digest11, {"cuda": digest11, label: digest})
        if device_kernel:
            check(br.counts["scalar_walk"] == 0, br.counts)
        else:
            check(br.counts["scalar_walk"] > 0, br.counts)
            check(all(br.counts[k] == 0 for k in TAS_KERNELS), br.counts)
        del d
        scenarios.release()
    check(kernels.LAUNCHES == before, "a CPU run launched a kernel")

    # -- 3e. the TAS kernels: seeded sweep, global-memory sort, captured -----
    # the walked levels of the descent launches by the route they took
    routes3e = {"warp": 0, "sort": 0}

    def tally(name, kw):
        if name == "fill_counts":
            return
        taken = kernels.TAS_ROUTES[name].cpu().tolist()
        for d in tas_levels(name, kw):
            routes3e[kernels.TAS_ROUTE_NAMES[taken[d]]] += 1

    for seed in (0, 1):
        for name, arrays, kw in testing.tas_cases(
                seed, testing.TAS_ALL, flat=4096):
            compare(name, on_card(arrays), kw, stats)
            tally(name, kw)
    smem_sort = kernels.TAS_SMEM_SORT
    kernels.TAS_SMEM_SORT = 0
    try:
        for name, arrays, kw in testing.tas_cases(
                0, ("three_levels", "flat", "shuffled", "wide_runs")):
            if name != "fill_counts":
                compare(name, on_card(arrays), kw, stats)
                tally(name, kw)
    finally:
        kernels.TAS_SMEM_SORT = smem_sort
    check(routes3e["warp"] > 0 and routes3e["sort"] > 0, routes3e)
    log(f"[3e TAS routes of the sweep's walked levels] "
        f"{json.dumps(routes3e)}")
    n_captured = 0
    for name in TAS_KERNELS:
        for args, kw in cap.calls.get(("tas", name), []):
            compare(name, args, kw, stats)
            n_captured += 1
    for name, s in stats.items():
        check(s["mismatches"] == 0, (name, s))
    log(f"[3 kernels, TAS sweep + {n_captured} captured] "
        f"{json.dumps({k: stats[k] for k in TAS_KERNELS})}")

    # -- 13. the north-star probe at full size, on the card ------------------
    from kueue_tpu_torch import probe
    from kueue_tpu_torch.ops import cycle
    install_phase1_capture(cap)
    cap.install(cycle, "admit_scan", "admit_scan")   # the flat 1,000 heads
    cap.phase = "probe"
    kernels.reset_counts()
    t13 = time.perf_counter()
    with DeviceClock() as dc13:
        r13 = probe.run(PROBE["W"], PROBE["C"], device="cuda",
                        reps=PROBE["reps"])
    t13 = time.perf_counter() - t13
    launches13 = dict(kernels.LAUNCHES)
    cap.uninstall()
    calls13 = PROBE["reps"] + 1
    path13 = PHASE1 + ("admit_scan", "admit_scan_forests")
    log(f"[13 probe] {PROBE['W']} heads x {PROBE['C']} CQs: "
        + "; ".join(f"{label} p50 {x['p50_ms']:.6f}ms worst "
                    f"{x['worst_ms']:.6f}ms" for label, x in r13.items())
        + f"; launches {json.dumps({k: launches13[k] for k in path13})}"
        f"; device ms per launch "
        f"{json.dumps({k: per_launch(dc13, k) for k in path13})}"
        f"; {device_line('13', dc13, t13, launches13)}")
    check(launches13["kq_cq_avail"] == 3 * calls13, launches13)
    check(launches13["kq_classify_heads"] == 3 * calls13, launches13)
    check(launches13["kq_cycle_order"] == 2 * calls13, launches13)
    check(launches13["admit_scan"] == calls13, launches13)
    check(launches13["admit_scan_forests"] == calls13, launches13)
    t0 = time.perf_counter()
    for label, name, args, kw in probe.probe_calls(PROBE["W"], PROBE["C"]):
        want = getattr(cycle, name + "_plain")(
            *[torch.from_numpy(np.ascontiguousarray(a)) for a in args],
            **kw)
        got = r13[label]["outputs"]
        for w_, g in zip(want, got):
            check(g.dtype == w_.dtype and torch.equal(g.cpu(), w_),
                  f"probe {label}: the card differs from the plain version")
        if label == "classify":
            fits13 = int((want[4] >= 0).sum())
        if label == "flat":
            admitted13 = int(want[0].sum())
    log(f"[13 probe] outputs equal to the plain versions on the host CPU "
        f"({time.perf_counter() - t0:.1f}s): {fits13} fits of "
        f"{PROBE['W']}, {admitted13} of {PROBE['C']} heads admitted")

    # -- 3f. the phase-1 kernels: seeded sweep, both routes, captured -------
    for seed in (0, 1):
        for name, arrays, kw in testing.solve_cycle_cases(seed):
            compare(name, on_card(arrays), kw, stats)
    # the other route of each: the classify's loop on every shape, the
    # sort in global scratch
    saved = (kernels.CLASSIFY_LANES, kernels.SORT_SMEM)
    kernels.CLASSIFY_LANES, kernels.SORT_SMEM = 0, 0
    try:
        for name, arrays, kw in testing.solve_cycle_cases(2):
            if name == "kq_classify_heads":
                compare(name, on_card(arrays), kw, stats)
        for W in (5, 1000):
            compare("kq_cycle_order", on_card(testing.order_case(
                np.random.default_rng(W), W)), {}, stats)
    finally:
        kernels.CLASSIFY_LANES, kernels.SORT_SMEM = saved
    n_captured = 0
    for name in PHASE1:
        for args, kw in cap.calls.get(("probe", name), []):
            compare(name, args, kw, stats)
            n_captured += 1
    for name, s in stats.items():
        check(s["mismatches"] == 0, (name, s))
    log(f"[3 kernels, phase-1 sweep + {n_captured} captured] "
        f"{json.dumps({k: stats[k] for k in PHASE1})}")

    # -- 14. entry() on the card and the CPU; the native route ----------------
    kernels.reset_counts()
    step, args = scenarios.entry(device="cuda")
    got = step(*args)
    torch.cuda.synchronize()
    step_cpu, args_cpu = scenarios.entry(device="cpu")
    want = step_cpu(*args_cpu)
    for w_, g in zip(want, got):
        check(g.dtype == w_.dtype and torch.equal(g.cpu(), w_),
              "entry(): the card differs from the CPU")
    d, clock, total, waves = scenarios.build_bench(
        PARITY_SCALE, device="cuda", solver_backend="native")
    r14 = scenarios.run_bench(d, clock, total, waves)
    torch.cuda.synchronize()
    launches14 = dict(kernels.LAUNCHES)
    digest14 = scenarios.decision_digest(d, r14["decisions"])
    ss = d.scheduler.solver.stats
    log(f"[14 entry] {len(got[0])} heads, {int(got[0].sum())} admitted, "
        f"equal on the card and the CPU; [14 native] {r14['finished']}/"
        f"{total} drained, {r14['preempted']} preempted, native_dispatches "
        f"{ss['native_dispatches']}, cuda_dispatches "
        f"{ss['cuda_dispatches']}, native_ff_fallbacks "
        f"{ss['native_ff_fallbacks']}, digest {digest14} (phase 6: "
        f"{digest6}); launches {json.dumps(launches14)}")
    check(r14["finished"] == total, "native: not drained")
    check(digest14 == digest6, {"native": digest14, "phase 6": digest6})
    check(ss["native_dispatches"] > 0, ss)
    del d, waves
    scenarios.release()

    # -- 3h. the shapes past the launchers' old limits ------------------------
    t0 = time.perf_counter()
    n3h = {}
    for name, arrays, kw in testing.shape_cases(0, card=True):
        compare(name, on_card(arrays), kw, stats)
        shape = dict(depth=kw.get("depth"),
                     F=int(arrays[0].shape[-1]) if name != "burst_cycles"
                     else int(arrays[17].shape[1]))
        n3h.setdefault(name, []).append(shape)
    # the forest-parallel flat scan and the burst on both routes: the
    # flat scan's layouts (testing.flat_scan_cases: one forest past a
    # block's shared memory among them) with and without the forest
    # tables, a burst window and one forest of every CQ, with shared
    # memory and with none allowed (every block on its global route)
    saved = (kernels.FLAT_SMEM, kernels.BURST_STATE_SMEM)
    try:
        for smem in (saved, (0, 0)):
            kernels.FLAT_SMEM, kernels.BURST_STATE_SMEM = smem
            for _, arrays, kw, (fon, nf) in testing.flat_scan_cases(
                    0, card=True):
                a = on_card(arrays)
                compare("admit_scan", a, kw, stats)
                compare("admit_scan", a, dict(
                    kw, forest_of_node=torch.from_numpy(fon).cuda(),
                    n_forests=nf), stats)
            for name, arrays, kw in testing.kernel_cases(0):
                if name == "admit_scan_forests":
                    compare(name, on_card(arrays), kw, stats)
            for _, arrays, depth, (fon, nf) in testing.preempt_route_cases():
                compare("admit_scan_preempt", on_card(arrays), dict(
                    depth=depth, forest_of_node=torch.from_numpy(fon).cuda(),
                    n_forests=nf), stats)
            for _, arrays, kw in (next(testing.burst_cases(0)),
                                  ("one_forest",
                                   *testing.burst_one_forest(0))):
                compare("burst_cycles", [
                    torch.from_numpy(a).cuda() if isinstance(a, np.ndarray)
                    else int(a) for a in arrays], kw, stats)
    finally:
        kernels.FLAT_SMEM, kernels.BURST_STATE_SMEM = saved
    # the batched search's layouts: an S past a multiple of its searches
    # per block, K = 1,024, F = 40, a tree and candidates past shared
    # memory (testing.search_route_cases), each on the route its shapes
    # give
    for label, arrays, kw, route in testing.search_route_cases(0):
        compare("minimal_preemptions_batch", on_card(arrays), kw, stats)
        r = kernels.SEARCH_ROUTES
        check((r["tree"], r["candidates"]) == {
            "shared": ("shared", "shared"), "global": ("global", "global"),
            "tree global": ("global", "shared"),
            "candidates global": ("shared", "global")}[route],
              (label, route, r))
        n3h.setdefault("minimal_preemptions_batch", []).append(label)
    for name in ROUTED:
        check(ROUTES_TAKEN.get(name, {"shared", "global"})
              <= set(stats[name]["routes"]), (name, stats[name]["routes"]))
    for name, s_ in stats.items():
        check(s_["mismatches"] == 0, (name, s_))
    log(f"[3h kernels past the old limits, both routes] {json.dumps(n3h)} "
        f"in {time.perf_counter() - t0:.1f}s; "
        f"{json.dumps({k: stats[k] for k in set(n3h) | set(ROUTED)})}")
    # the cost of a deep chain: the same 1,000 heads over 6 CQs under a
    # cohort chain of 16 levels (depth 17) and of 1 level (depth 2)
    t3h = {}
    for n_cohorts in (16, 1):
        c = testing.admit_cycle(np.random.default_rng(1), n_cqs=6,
                                n_cohorts=n_cohorts, depth=2, F=3,
                                W=1000, R=2, chain=True)
        args3h = on_card(testing.admit_args(c))
        compare("admit_scan", args3h, dict(depth=c["depth"]), stats)
        t3h[f"depth_{c['depth']}"] = {
            k: v for k, v in time_kernel(
                "admit_scan", args3h, dict(depth=c["depth"])).items()
            if k in ("ms", "plain_ms")}
    check(stats["admit_scan"]["mismatches"] == 0, stats["admit_scan"])
    log(f"[3h admit_scan, 1,000 heads, by chain depth] {json.dumps(t3h)}")

    # -- 15. the north-star shape through the forest-sharded burst ---------
    from kueue_tpu_torch.ops.packing import pack_scatter_rows, scatter_layout
    from kueue_tpu_torch.parallel import sharded
    install_shard_capture(cap)
    cap.phase = "northstar_sharded"
    os.environ["KUEUE_TPU_SHARDS"] = str(NORTHSTAR_SHARDS)
    try:
        with sharded.virtual_mesh("cuda:0", NORTHSTAR_SHARDS):
            t0 = time.perf_counter()
            d, clock, total, wave = scenarios.build_northstar(
                NORTHSTAR["n_cqs"], NORTHSTAR["n_wl"], device="cuda")
            d.scheduler.solver.warmup(d.cache.snapshot(), NORTHSTAR["n_cqs"])
            build_s = time.perf_counter() - t0
            gc.collect()
            kernels.reset_counts()
            with DeviceClock() as dc15, GCWatch() as gc15:
                r15 = scenarios.northstar_burst(d, clock, wave,
                                                cycles=NORTHSTAR["cycles"])
            launches15 = dict(kernels.LAUNCHES)
    finally:
        del os.environ["KUEUE_TPU_SHARDS"]
    cap.uninstall()
    bs = d._burst_solver
    digest15 = scenarios.decision_digest(d, r15["decisions"])
    pct = scenarios.percentile
    log(f"[15 northstar sharded burst] {bs.n_shards} virtual shards on "
        f"cuda:0, {total} workloads (built in {build_s:.1f}s), "
        f"{r15['cycles']} cycles in {r15['wall']:.2f}s, cycle p50 "
        f"{pct(r15['cycle_times'], 0.5) * 1e3:.3f}ms p99 "
        f"{pct(r15['cycle_times'], 0.99) * 1e3:.3f}ms (phase 8 serial: "
        f"{r8['wall']:.2f}s, p50 {pct(r8['cycle_times'], 0.5) * 1e3:.3f}ms "
        f"p99 {pct(r8['cycle_times'], 0.99) * 1e3:.3f}ms, {gc8.line()}), "
        f"{gc15.line()}, admitted "
        f"{r15['admitted']}, preempted {r15['preempted']}, digest "
        f"{digest15} (phase 8: {digest8}); burst_shard_pack_s "
        f"{json.dumps(bs.stats['burst_shard_pack_s'])}, "
        f"burst_shard_fetch_s {json.dumps(bs.stats['burst_shard_fetch_s'])}"
        f"; {device_line('15', dc15, r15['wall'], launches15)}")
    burst_line("15 northstar sharded burst", d, r15, launches15)
    check(bs.n_shards == NORTHSTAR_SHARDS, bs.n_shards)
    check(digest15 == digest8, {"sharded": digest15, "phase 8": digest8})
    n_sharded = bs.stats["burst_sharded_dispatches"]
    check(n_sharded >= 1, bs.stats)
    check(launches15["kq_reduce_dflags"] == n_sharded,
          (launches15, n_sharded))
    check(launches15["burst_cycles"] == NORTHSTAR_SHARDS * n_sharded
          + bs.stats["burst_dispatches"] - n_sharded, launches15)
    check(gc15.n == 0, f"phase 15: {gc15.line()}")
    del d, bs
    scenarios.release()

    # -- 15b. resident reuse on 8 virtual shards, then 8 → 4 ---------------
    install_shard_capture(cap)
    cap.phase = "resident"
    os.environ["KUEUE_TPU_RESIDENT_VERIFY"] = "1"
    try:
        serial = scenarios.sustained_drain(device="cuda")
        serial_split = scenarios.sustained_drain(device="cuda", lose=4)
        with sharded.virtual_mesh("cuda:0", RESIDENT_SHARDS):
            kernels.reset_counts()
            r15b = scenarios.sustained_drain(device="cuda",
                                             shards=RESIDENT_SHARDS)
            torch.cuda.synchronize()
            launches15b = dict(kernels.LAUNCHES)
            r15c = scenarios.sustained_drain(
                device="cuda", shards=RESIDENT_SHARDS, lose=4)
    finally:
        del os.environ["KUEUE_TPU_RESIDENT_VERIFY"]
    cap.uninstall()
    st = r15b["stats"]
    log(f"[15b resident] {RESIDENT_SHARDS} virtual shards: "
        f"{len(r15b['records'])} cycles, records equal to the serial "
        f"drain: {r15b['records'] == serial['records']}; boundary "
        f"{boundary_report(st)}; launches "
        f"{json.dumps({k: launches15b[k] for k in ('burst_cycles',) + SHARD_KERNELS})}"
        f"; after lose_devices(4): shards {r15c['shards']}, records equal "
        f"to the serial split drain: "
        f"{r15c['records'] == serial_split['records']}, resident misses "
        f"{r15c['stats']['burst_resident_misses']}")
    check(r15b["records"] == serial["records"], "15b: records differ")
    check(st["burst_resident_hits"] >= 1, st)
    check(st["burst_resident_scatter_rows"] >= 1, st)
    check(launches15b["kq_scatter_rows"] >= 1, launches15b)
    check(launches15b["kq_reduce_dflags"] == st["burst_sharded_dispatches"],
          launches15b)
    check(st["burst_boundary_bytes_h2d"] < st["burst_boundary_bytes_equiv"],
          st)
    check(r15c["shards"] == [RESIDENT_SHARDS, 4], r15c["shards"])
    check(r15c["records"] == serial_split["records"],
          "15b: records differ after lose_devices(4)")
    check(r15c["stats"]["burst_shard_degradations"] == 1, r15c["stats"])
    del serial, serial_split, r15b, r15c
    scenarios.release()

    # -- 15c. resident reuse at north-star width on 4 virtual shards -------
    install_shard_capture(cap)
    cap.phase = "northstar_resident"
    wide = dict(device="cuda", n_cqs=NORTHSTAR["n_cqs"], runtime=30)
    os.environ["KUEUE_TPU_RESIDENT_VERIFY"] = "1"
    try:
        t0 = time.perf_counter()
        serial_w = scenarios.sustained_drain(**wide)
        serial_w_s = time.perf_counter() - t0
        with sharded.virtual_mesh("cuda:0", NORTHSTAR_SHARDS):
            kernels.reset_counts()
            t0 = time.perf_counter()
            with DeviceClock() as dc15w, GCWatch() as gc15w:
                r15w = scenarios.sustained_drain(shards=NORTHSTAR_SHARDS,
                                                 **wide)
            r15w_s = time.perf_counter() - t0
            launches15w = dict(kernels.LAUNCHES)
    finally:
        del os.environ["KUEUE_TPU_RESIDENT_VERIFY"]
    cap.uninstall()
    st = r15w["stats"]
    log(f"[15c resident at north-star width] {NORTHSTAR['n_cqs']} CQs, "
        f"{NORTHSTAR_SHARDS} virtual shards: {len(r15w['records'])} "
        f"cycles in {r15w_s:.2f}s (serial on the card {serial_w_s:.2f}s; "
        f"both with the VERIFY gathers), admitted "
        f"{sum(len(r[0]) for r in r15w['records'])}, preempted "
        f"{sum(len(r[3]) for r in r15w['records'])}, records equal to the "
        f"serial drain: {r15w['records'] == serial_w['records']}; boundary "
        f"{boundary_report(st)}; launches "
        f"{json.dumps({k: launches15w[k] for k in ('burst_cycles',) + SHARD_KERNELS})}"
        f"; {gc15w.line()}; {device_line('15c', dc15w, r15w_s, launches15w)}")
    hits15w = max(1, st["burst_resident_hits"])
    log(f"[15c resident scatter] per resident hit: "
        f"burst_resident_scatter_s {st['burst_resident_scatter_s'] / hits15w:.6f}"
        f", host-to-device copies {st['burst_resident_scatter_copies'] / hits15w:.3f}"
        f" ({st['burst_resident_scatter_copies']} copies, "
        f"{launches15w['kq_scatter_rows']} kq_scatter_rows launches, "
        f"{st['burst_resident_hits']} hits, {NORTHSTAR_SHARDS} shards)")
    check(r15w["records"] == serial_w["records"], "15c: records differ")
    check(gc15w.n == 0, f"phase 15c: {gc15w.line()}")
    check(st["burst_resident_scatter_copies"]
          == launches15w["kq_scatter_rows"], (st, launches15w))
    check(st["burst_resident_hits"] >= 1, st)
    check(st["burst_resident_scatter_rows"] >= 1, st)
    check(launches15w["kq_scatter_rows"] >= 1, launches15w)
    check(launches15w["kq_reduce_dflags"] == st["burst_sharded_dispatches"],
          launches15w)
    check(st["burst_boundary_bytes_h2d"] < st["burst_boundary_bytes_equiv"],
          st)
    check(any(r[3] for r in r15w["records"]), "15c: no preemption")

    # -- 3g. the two sharded-burst kernels: seeded and captured -------------
    # packed buffers: padded duplicate rows, a row past the planes,
    # 5-byte bool rows, 16-byte rows; all 250 rows of a shard dirty
    for seed, C, D in ((0, 12, 1), (1, 12, 3), (2, 12, 9), (3, 12, 12),
                       (4, 250, 250)):
        planes, rows, vals = testing.scatter_case(seed, C=C, D=D)
        compare("kq_scatter_rows", [
            tuple(on_card(planes)),
            torch.from_numpy(pack_scatter_rows(rows, vals)).cuda(),
            len(rows)], {}, stats)
    for S, K in ((2, 32), (4, 32), (8, 32), (32, 32), (4, 7)):
        compare("kq_reduce_dflags",
                on_card([testing.dflags_blocks(S, K)]), {}, stats)
    n_captured = 0
    for phase in ("northstar_sharded", "resident", "northstar_resident"):
        for name in SHARD_KERNELS:
            for args, kw in cap.calls.get((phase, name), []):
                compare(name, args, kw, stats)
                n_captured += 1
    for name in SHARD_KERNELS:
        check(stats[name]["mismatches"] == 0, (name, stats[name]))
    log(f"[3g sharded-burst kernels, seeded + {n_captured} captured] "
        f"{json.dumps({k: stats[k] for k in SHARD_KERNELS})}")

    # -- 16. the perf scenario through the per-cycle mesh ------------------
    install_mesh_capture(cap)
    cap.phase = "bench_mesh"
    with sharded.virtual_mesh("cuda:0", MESH_SHARDS["bench"]):
        d, clock, total, waves = scenarios.build_bench(
            BENCH_WORKLOADS / 15_000, device="cuda",
            shards=MESH_SHARDS["bench"])
        d.scheduler.solver.warmup(d.cache.snapshot(),
                                  len(d.cache.cluster_queue_names()))
        gc.collect()      # phases 16-16c start from a collected heap
        kernels.reset_counts()
        with DeviceClock() as dc16, GCWatch() as gc16:
            r16 = scenarios.run_bench(d, clock, total, waves)
        launches16 = dict(kernels.LAUNCHES)
    cap.uninstall()
    ss = d.scheduler.solver.stats
    digest16 = scenarios.decision_digest(d, r16["decisions"])
    log(f"[16 bench mesh] drained {r16['finished']}/{r16['total']}, "
        f"{r16['finished'] / r16['wall']:.1f} admissions/s (phase 4: "
        f"{BENCH_WORKLOADS / wall4:.1f}), preempted {r16['preempted']}")
    mesh_line("16 bench mesh", d, r16, launches16, dc16, digest16,
              digest4, wall4, gc16)
    check(d.scheduler.solver.mesh.shape == {"wl": 2, "cq": 2},
          d.scheduler.solver.mesh.shape)
    check(digest16 == digest4, {"mesh": digest16, "phase 4": digest4})
    check(ss["sharded_dispatches"] > 0 and ss["sharded_preempt_dispatches"]
          > 0, ss)
    check(launches16["kq_gather_heads"] == ss["sharded_dispatches"],
          (launches16, ss["sharded_dispatches"]))
    for k in ("admit_scan", "admit_scan_preempt",
              "minimal_preemptions_batch"):
        check(launches16[k] > 0, (k, launches16))
    check(sum(sum(v) for v in ss["sharded_shard_launches"].values())
          == launches16["admit_scan"] + launches16["admit_scan_preempt"]
          + launches16["admit_scan_forests"], ss["sharded_shard_launches"])
    del d, waves
    scenarios.release()

    # -- 16b. the north-star shape through the per-cycle mesh ---------------
    install_mesh_capture(cap)
    cap.phase = "northstar_mesh"
    with sharded.virtual_mesh("cuda:0", MESH_SHARDS["northstar"]):
        t0 = time.perf_counter()
        d, clock, total, wave = scenarios.build_northstar(
            NORTHSTAR["n_cqs"], NORTHSTAR["n_wl"], device="cuda",
            shards=MESH_SHARDS["northstar"])
        d.scheduler.solver.warmup(d.cache.snapshot(), NORTHSTAR["n_cqs"])
        build_s = time.perf_counter() - t0
        gc.collect()
        kernels.reset_counts()
        with DeviceClock() as dc16b, GCWatch() as gc16b:
            r16b = scenarios.run_northstar(d, clock, wave,
                                           cycles=NORTHSTAR["cycles"])
        launches16b = dict(kernels.LAUNCHES)
    cap.uninstall()
    ss = d.scheduler.solver.stats
    digest16b = scenarios.decision_digest(d, r16b["decisions"])
    log(f"[16b northstar mesh] built in {build_s:.1f}s, admitted "
        f"{r16b['admitted']}, preempted {r16b['preempted']}")
    mesh_line("16b northstar mesh", d, r16b, launches16b, dc16b,
              digest16b, digest5, r5["wall"], gc16b)
    check(d.scheduler.solver.mesh.shape == {"wl": 4, "cq": 2},
          d.scheduler.solver.mesh.shape)
    check(digest16b == digest5, {"mesh": digest16b, "phase 5": digest5})
    check(ss["sharded_preempt_dispatches"] > 0, ss)
    check(launches16b["admit_scan_forests"] > 0, launches16b)
    check(launches16b["kq_gather_heads"] == ss["sharded_dispatches"],
          (launches16b, ss["sharded_dispatches"]))
    check(gc16b.n == 0, f"phase 16b: {gc16b.line()}")
    del d
    scenarios.release()

    # -- 16c. fair sharing at the north-star size through the mesh ----------
    install_mesh_capture(cap)
    cap.phase = "northstar_fs_mesh"
    with sharded.virtual_mesh("cuda:0", MESH_SHARDS["fs"]):
        t0 = time.perf_counter()
        d, clock, total = scenarios.build_northstar_fs(
            NORTHSTAR["n_cqs"], NORTHSTAR["n_wl"], device="cuda",
            shards=MESH_SHARDS["fs"])
        d.scheduler.solver.warmup(d.cache.snapshot(), NORTHSTAR["n_cqs"])
        build_s = time.perf_counter() - t0
        gc.collect()
        kernels.reset_counts()
        with DeviceClock() as dc16c, GCWatch() as gc16c:
            r16c = scenarios.run_northstar_fs(d, clock,
                                              cycles=NORTHSTAR["cycles"])
        launches16c = dict(kernels.LAUNCHES)
    cap.uninstall()
    ss = d.scheduler.solver.stats
    digest16c = scenarios.decision_digest(d, r16c["decisions"])
    log(f"[16c northstar fs mesh] built in {build_s:.1f}s, admitted "
        f"{r16c['admitted']}, skipped {r16c['skipped']}")
    mesh_line("16c northstar fs mesh", d, r16c, launches16c, dc16c,
              digest16c, digest9, r9["wall"], gc16c)
    check(digest16c == digest9, {"mesh": digest16c, "phase 9": digest9})
    check(ss["sharded_fs_dispatches"] > 0, ss)
    check(launches16c["fs_admit_scan"] > 0, launches16c)
    check(launches16c["kq_fs_merge_order"] == ss["sharded_fs_dispatches"],
          (launches16c, ss["sharded_fs_dispatches"]))
    check(launches16c["kq_gather_heads"] >= ss["sharded_fs_dispatches"],
          launches16c)
    check(gc16c.n == 0, f"phase 16c: {gc16c.line()}")
    del d
    scenarios.release()

    # -- 16d. the multi-chip dry run on a virtual mesh of the card ----------
    install_mesh_capture(cap)
    install_phase1_capture(cap)
    cap.phase = "dryrun"
    with sharded.virtual_mesh("cuda:0", MESH_SHARDS["dryrun"]):
        kernels.reset_counts()
        t16d = time.perf_counter()
        with DeviceClock() as dc16d:
            r16d = scenarios.dryrun_multichip(MESH_SHARDS["dryrun"],
                                              device="cuda")
        t16d = time.perf_counter() - t16d
        launches16d = dict(kernels.LAUNCHES)
    cap.uninstall()
    log(f"[16d dryrun_multichip] {json.dumps(r16d)}; launches "
        f"{json.dumps({k: v for k, v in launches16d.items() if v})}; "
        f"device ms per launch "
        f"{json.dumps({k: per_launch(dc16d, k) for k in PHASE1})}; "
        f"{device_line('16d', dc16d, t16d, launches16d)}")
    for k in PHASE1 + ("admit_scan", "admit_scan_preempt",
                       "kq_gather_heads"):
        check(launches16d[k] > 0, (k, launches16d))

    # -- 17. the reference perf harness at full size ------------------------
    import yaml
    from kueue_tpu_torch.perf import harness
    here = os.path.dirname(os.path.abspath(__file__))
    gen = os.path.join(here, "perf", "default_generator_config.yaml")
    spec_path = os.path.join(here, "perf", "default_rangespec.yaml")
    with open(spec_path) as f:
        spec = yaml.safe_load(f)
    t0 = time.perf_counter()
    # a process of its own, started by the launcher, so that maxrss and
    # mCPU are the harness's
    proc = launcher.run(
        [sys.executable, "-m", "kueue_tpu_torch.perf.harness", gen,
         spec_path], cwd=here, env=dict(os.environ, PYTHONPATH=here),
        timeout=HARNESS_TIMEOUT_S)
    child_s = time.perf_counter() - t0
    try:
        h17 = json.loads(proc.stdout)
    except json.JSONDecodeError:
        raise RuntimeError(f"phase 17: no JSON from the harness (exit "
                           f"{proc.returncode}): {proc.stdout[-2000:]}\n"
                           f"{proc.stderr[-4000:]}") from None
    tta = h17["avg_time_to_admission_ms"]
    fails17 = [ln[len("RANGESPEC FAIL: "):]
               for ln in proc.stderr.splitlines()
               if ln.startswith("RANGESPEC FAIL: ")]
    cmd = spec["cmd"]
    log(f"[17 perf harness] python -m kueue_tpu_torch.perf.harness "
        f"(exit {proc.returncode}, {child_s:.1f}s): {json.dumps(h17)}; "
        f"rangespec failures {json.dumps(fails17)}; host figures against "
        f"their limits: wall {h17['wall_ms']}ms (maxWallMs "
        f"{cmd['maxWallMs']}), cpu {h17['cpu_mcpu']}mCPU (mCPU "
        f"{cmd['mCPU']}), maxrss {h17['maxrss_kb']}KB (maxrss "
        f"{cmd['maxrss']}KB, set for a JAX process); on the card "
        f"{h17['virtual_ms'] / 1e3} virtual s, avg time to admission (s) "
        f"{json.dumps({k: v / 1e3 for k, v in tta.items()})}, min CQ usage "
        f"{h17['min_avg_usage_pct'].get('cq')}%, beside the JAX replay's "
        f"record (README): {README_REPLAY}")
    check(proc.returncode in (0, 1), ("phase 17 exit", proc.returncode,
                                      proc.stderr[-4000:]))
    check(proc.returncode == 0 or fails17, proc.stderr[-4000:])
    check(h17["finished"] == h17["workloads"] == BENCH_WORKLOADS, h17)
    check(set(tta) == {"small", "medium", "large"}
          and tta["large"] < tta["medium"] < tta["small"], tta)
    check(not [f for f in fails17
               if f.startswith(("usage[", "timeToAdmission["))], fails17)

    # the cut config in this process, on the card and on the CPU
    with open(gen) as f:
        cut = yaml.safe_load(f)
    cut[0]["count"] = 1
    for ws in cut[0]["queuesSets"][0]["workloadsSets"]:
        ws["count"] //= 5
    kernels.reset_counts()
    with DeviceClock() as dc17:
        s17 = harness.run_scenario(cut, device="cuda")
    launches17 = dict(kernels.LAUNCHES)
    s17c = harness.run_scenario(cut, device="cpu")
    virtual = ("admitted", "finished", "virtual_ms",
               "avg_time_to_admission_ms", "min_avg_usage_pct")
    v17 = {k: getattr(s17, k) for k in virtual}
    log(f"[17 perf harness, 1 cohort x 6 CQs, "
        f"{s17.total_workloads} workloads] cuda {json.dumps(v17)} in "
        f"{s17.wall_ms / 1e3:.2f}s; cpu equal: "
        f"{v17 == {k: getattr(s17c, k) for k in virtual}} "
        f"({s17c.wall_ms / 1e3:.2f}s); launches "
        f"{json.dumps({k: v for k, v in launches17.items() if v})}; "
        f"{device_line('17', dc17, s17.wall_ms / 1e3, launches17)}")
    check(v17 == {k: getattr(s17c, k) for k in virtual},
          ("phase 17: card and CPU differ", v17, s17c))
    check(s17.finished == s17.total_workloads, s17)
    for k in ("admit_scan", "admit_scan_preempt",
              "minimal_preemptions_batch"):
        check(launches17[k] > 0, (k, launches17))
    del s17, s17c
    scenarios.release()

    # -- 18. the job front door at tas-4k's size ----------------------------
    with scenarios.restore_gates():
        t0 = time.perf_counter()
        d, clock, mgr, plan = scenarios.build_jobs(device="cuda")
        build_s = time.perf_counter() - t0
        kernels.reset_counts()
        with (scenarios.TASBranches() as br18, DeviceClock() as dc18,
              GCWatch() as gc18):
            r18 = scenarios.run_jobs(d, clock, mgr, plan)
        launches18 = dict(kernels.LAUNCHES)
    digest18 = scenarios.jobs_digest(d, r18)
    pct = scenarios.percentile
    log(f"[18 jobs-tas-4k] {len(d.cache.tas.nodes)} nodes, "
        f"{len(list(d.queues.cluster_queue_names()))} CQs, "
        f"{r18['jobs']} jobs (built in {build_s:.1f}s), {r18['steps']} "
        f"steps in {r18['wall']:.2f}s (schedule_once "
        f"{sum(r18['cycle_times']):.2f}s, the job layer the rest), cycle p50 "
        f"{pct(r18['cycle_times'], 0.5) * 1e3:.3f}ms p99 "
        f"{pct(r18['cycle_times'], 0.99) * 1e3:.3f}ms; admitted "
        f"{r18['admitted']}, completed {r18['completed']}, preempted "
        f"{r18['preempted']}, PodsReady timeouts {r18['timed_out']} "
        f"(deactivated {r18['deactivated']}), stopped "
        f"{len(r18['stopped'])} "
        f"({json.dumps(Counter(s[1] for s in r18['stopped']))}), refused "
        f"{len(r18['refused'])}; started by kind "
        f"{json.dumps(r18['started_kinds'])}; branches "
        f"{json.dumps(br18.counts)}; digest {digest18}; {gc18.line()}; "
        f"launches {json.dumps({k: v for k, v in launches18.items() if v})}"
        f"; {device_line('18', dc18, r18['wall'], launches18)}")
    check(set(r18["started_kinds"]) == set(scenarios.JOB_KINDS),
          r18["started_kinds"])
    check(r18["preempted"] > 0 and r18["stopped"], "phase 18: no preemption")
    check(r18["preempted_unstopped"] == [], r18["preempted_unstopped"][:5])
    check(all(restored for _, _, restored in r18["stopped"]),
          [s for s in r18["stopped"] if not s[2]][:5])
    check(r18["refused"], "phase 18: the webhook refused nothing")
    for k in TAS_KERNELS + ("admit_scan", "admit_scan_preempt"):
        check(launches18[k] > 0, (k, launches18))
    check(br18.counts["scalar_walk"] == 0, br18.counts)
    check(gc18.n == 0, f"phase 18: {gc18.line()}")
    del d, mgr, plan, r18
    scenarios.release()

    before = dict(kernels.LAUNCHES)
    with scenarios.restore_gates():
        d, clock, mgr, plan = scenarios.build_jobs(device="cpu")
        r = scenarios.run_jobs(d, clock, mgr, plan)
    digest = scenarios.jobs_digest(d, r)
    log(f"[18 jobs parity] cpu: {r['steps']} steps in {r['wall']:.2f}s, "
        f"admitted {r['admitted']}, digest {digest}")
    check(digest == digest18, {"cuda": digest18, "cpu": digest})
    check(kernels.LAUNCHES == before, "the CPU run launched a kernel")
    del d, mgr, plan, r
    scenarios.release()

    # -- 3i. the mesh kernels and the per-shard scans against plain ---------
    mesh_phases = ("bench_mesh", "northstar_mesh", "northstar_fs_mesh",
                   "dryrun")
    t0 = time.perf_counter()
    n_captured = {}
    for phase in mesh_phases:
        for name in MESH_KERNELS + MESH_SCANS + PHASE1:
            for args, kw in cap.calls.get((phase, name), []):
                compare(name, args, kw, stats)
                n_captured[name] = n_captured.get(name, 0) + 1
    rng = np.random.default_rng(1000)
    planes, head_of, fills = testing.gather_case(
        rng, W=1000, S=8, dtypes=("bool", "bool", "bool"))
    synth_gather = [tuple(tuple(on_card(list(p))) for p in planes),
                    torch.from_numpy(sharded.source_map(head_of,
                                                        1000)).cuda(),
                    fills]
    compare("kq_gather_heads", synth_gather, {}, stats)
    winners, head_of = testing.merge_case(rng, W=1000, S=8)
    synth_merge = [tuple(on_card(list(winners))),
                   tuple(on_card(list(head_of))), 1000]
    compare("kq_fs_merge_order", synth_merge, {}, stats)
    for name in MESH_KERNELS + MESH_SCANS + PHASE1:
        check(stats[name]["mismatches"] == 0, (name, stats[name]))
    for name in MESH_KERNELS:
        check(n_captured.get(name), f"{name}: nothing captured in 16-16d")
    log(f"[3i mesh kernels, synthetic + captured {json.dumps(n_captured)}] "
        f"in {time.perf_counter() - t0:.1f}s; "
        f"{json.dumps({k: stats[k] for k in MESH_KERNELS + MESH_SCANS})}")

    # -- 3j. two launches taken apart: wrapper, bare C launch, library -----
    t0 = time.perf_counter()
    cases3j = [
        ("phase 15, S = 4", "kq_reduce_dflags",
         *cap.calls[("northstar_sharded", "kq_reduce_dflags")][0]),
        ("S = 8, K = 32", "kq_reduce_dflags",
         on_card([testing.dflags_blocks(8, 32)]), {}),
        ("phase 16b, widest", "kq_gather_heads",
         *widest_mesh("kq_gather_heads",
                      cap.calls[("northstar_mesh", "kq_gather_heads")])),
        ("1,000 heads x 8 shards", "kq_gather_heads", synth_gather, {}),
    ]
    j3 = launch_breakdown(cases3j)
    log(f"[3j launch breakdown] ({time.perf_counter() - t0:.1f}s) "
        f"{json.dumps(j3)}")

    # -- 3k. the profiler's clocks: the host op to its kernel, then and now -
    clock_offset1 = profiler_clock_offset()
    log(f"[3k profiler clock] host op to its kernel's start, µs: after the "
        f"build {json.dumps(clock_offset0)}; "
        f"{time.perf_counter() - t_start:.1f}s into the run "
        f"{json.dumps(clock_offset1)}; DeviceClock's margin "
        f"{DeviceClock.MARGIN_S * 1e6:.0f}µs")

    # -- the kernels line ----------------------------------------------------
    by_phase = {"4": launches4, "5": launches5, "7": launches7,
                "8": launches8, "9": launches9, "9b": launches9b,
                "11": launches11, "13": launches13, "14": launches14,
                "15": launches15, "15b": launches15b, "15c": launches15w,
                "16": launches16, "16b": launches16b, "16c": launches16c,
                "16d": launches16d, "17": launches17, "18": launches18}
    rows = []
    for name in kernels.KERNELS:
        phase = {"admit_scan_forests": "northstar",
                 "burst_cycles": "northstar_burst",
                 "fs_admit_scan": "northstar_fs",
                 "drs_components": "northstar_fs",
                 **dict.fromkeys(TAS_KERNELS, "tas"),
                 **dict.fromkeys(PHASE1, "probe"),
                 "kq_scatter_rows": "northstar_resident",
                 "kq_reduce_dflags": "northstar_sharded",
                 "kq_gather_heads": "northstar_mesh",
                 "kq_fs_merge_order": "northstar_fs_mesh"}.get(name,
                                                               "bench")
        calls = cap.calls.get((phase, name))
        check(calls, f"{name}: no captured {phase} call")
        args, kw = (burst_window(calls) if name == "burst_cycles"
                    else most_heads(calls) if name == "fs_admit_scan"
                    else deepest(calls) if name == "best_fit_descend"
                    else most_rows(calls) if name == "kq_scatter_rows"
                    else widest_mesh(name, calls) if name in MESH_KERNELS
                    else widest(calls) if name in PHASE1
                    else calls[0] if name in ("drs_components",
                                              "fill_counts",
                                              "split_across_roots",
                                              "kq_reduce_dflags")
                    else largest(calls))
        t = time_kernel(name, args, kw)
        launches = {"northstar": launches5, "bench": launches4,
                    "northstar_burst": launches8,
                    "northstar_fs": launches9, "tas": launches11,
                    "probe": launches13, "northstar_sharded": launches15,
                    "northstar_resident": launches15w,
                    "northstar_mesh": launches16b,
                    "northstar_fs_mesh": launches16c}[phase][name]
        extra = {}
        if name in ROUTED:
            extra["timed_route"] = route_of(name)
        if name == "kq_scatter_rows":
            rows_t = sharded.unpack_scatter_rows(*args)[0]
            extra["timed_shape"] = dict(
                planes=len(args[0]), rows=int(args[0][0].shape[0]),
                Dp=int(args[2]), distinct=int(torch.unique(rows_t).numel()),
                buffer_bytes=int(args[1].numel()),
                row_bytes=scatter_layout(args[0], args[2])[1])
            extra["device_ms_per_launch_on_path"] = per_launch(dc15w, name)
        if name == "kq_reduce_dflags":
            extra["timed_shape"] = dict(S=int(args[0].shape[0]),
                                        K=int(args[0].shape[1]))
        if name in MESH_KERNELS:
            path_dc = {"kq_gather_heads": dc16b,
                       "kq_fs_merge_order": dc16c}[name]
            extra["timed_shape"] = mesh_shape(name, args)
            extra["device_ms_per_launch_on_path"] = per_launch(path_dc, name)
            ts = time_kernel(name, synth_gather if name == "kq_gather_heads"
                             else synth_merge, {})
            extra["synthetic_1000x8"] = {k: ts[k] for k in (
                "ms", "bare_ms", "kernel_ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms")}
        if name in TAS_KERNELS:
            # the route each level of the timed call took, as the kernel
            # wrote it (fill_counts walks none)
            routes = (kernels.TAS_ROUTES[name].cpu().tolist()
                      if name in kernels.TAS_ROUTES else [])
            extra["dependent_steps"] = tas_dependent_steps(name, args, kw,
                                                           routes)
            extra["timed_shape"] = dict(
                level_sizes=list(kw["level_sizes"]),
                R=int(args[0].shape[1]),
                **{k: kw[k] for k in ("level", "profile", "descend_profile")
                   if k in kw},
                routes={d: kernels.TAS_ROUTE_NAMES[routes[d]]
                        for d in tas_levels(name, kw)})
            if name == "best_fit_descend":
                check(all(routes[d] == 1 for d in tas_levels(name, kw)),
                      f"best_fit_descend: not the warp route on every "
                      f"walked level of the timed tas-4k call: {routes}")
            extra["device_ms_per_launch_on_path"] = per_launch(dc11, name)
        if name == "fs_admit_scan":
            # the dependent chain: the largest forest's rounds beside the
            # others, and the membership and merge passes
            rounds, entry_rounds, node_rounds = fs_forest_work(args)
            extra["dependent_steps"] = fs_dependent_steps(args, kw)
            extra["timed_shape"] = dict(
                N=int(args[0].shape[0]), F=int(args[0].shape[1]),
                W=int(args[12].shape[0]), heads=rounds,
                depth=kw["depth"], n_levels=kw["n_levels"],
                n_forests=kw["n_forests"], max_forest=kw["max_forest"],
                threads=kernels.fs_threads(int(args[0].shape[1]),
                                           kw["max_forest"]))
            # the worst case: one forest holding the 1,000 CQs and 200
            # cohorts (nested under one root), its rounds all in one block
            c1 = testing.fs_cycle(np.random.default_rng(9), n_cqs=1000,
                                  n_cohorts=200, depth=3, F=1, R=1, W=1024,
                                  n_valid=1000, roots=1)
            a1, k1 = on_card(list(testing.fs_args(c1))), testing.fs_kw(c1)
            compare(name, a1, k1, stats)
            check(stats[name]["mismatches"] == 0, stats[name])
            t1 = time_kernel(name, a1, k1)
            extra["one_forest"] = dict(
                **{k: t1[k] for k in ("ms", "kernel_ms", "plain_ms",
                                      "bound_ms")},
                dependent_steps=fs_dependent_steps(a1, k1),
                shape=dict(N=int(a1[0].shape[0]), W=1024, heads=1000,
                           n_forests=k1["n_forests"],
                           max_forest=k1["max_forest"],
                           n_levels=k1["n_levels"],
                           threads=kernels.fs_threads(1, k1["max_forest"])))
        if name in PHASE1:
            extra["timed_shape"] = {
                "kq_cq_avail": lambda: dict(N=int(args[0].shape[0]),
                                            F=int(args[0].shape[1]),
                                            C=kw["n_cqs"]),
                "kq_classify_heads": lambda: dict(
                    W=int(args[0].shape[0]),
                    C_S_R=list(args[3].shape), pairs=kw["pairs"]),
                "kq_cycle_order": lambda: dict(W=int(args[0].shape[0])),
            }[name]()
            extra["device_ms_per_launch_on_path"] = per_launch(dc13, name)
            if name == "kq_classify_heads":
                # the 1,000-head call of the scans, with the pairs
                h_args, h_kw = min(cap.calls[("probe", name)],
                                   key=lambda c: c[0][0].shape[0])
                th = time_kernel(name, h_args, h_kw)
                extra["heads_1000_with_pairs"] = dict(
                    ms=th["ms"], plain_ms=th["plain_ms"],
                    bound_ms=th["bound_ms"], bound_by=th["bound_by"],
                    W=int(h_args[0].shape[0]))
        if name in ROUTED:
            extra["routes"] = stats[name].get("routes")
        if name == "admit_scan":
            # the perf-15k call timed above, the probe's flat 1,000 heads
            # (64 forests) and the worst case, one forest of 1,000 CQs
            # under 64 cohorts with 1,000 heads
            extra["dependent_steps"] = flat_dependent_steps(args, kw)
            extra["timed_shape"] = dict(
                N=int(args[0].shape[0]), F=int(args[0].shape[1]),
                W=int(args[8].shape[0]), depth=kw["depth"],
                tables=kw.get("forest_of_node") is not None)
            extra["device_ms_per_launch_on_path"] = per_launch(dc4, name)
            extra["device_ms_per_launch_mesh"] = per_launch(dc16, name)
            p_args, p_kw = cap.calls[("probe", name)][0]
            tp = time_kernel(name, p_args, p_kw)
            extra["probe_1000_heads"] = dict(
                **{k: tp[k] for k in ("ms", "kernel_ms", "plain_ms",
                                      "bound_ms", "bound_by")},
                device_ms_per_launch_on_path=per_launch(dc13, name),
                dependent_steps=flat_dependent_steps(p_args, p_kw))
            c1 = testing.admit_cycle(np.random.default_rng(7), n_cqs=1000,
                                     n_cohorts=64, depth=3, F=12, W=1000,
                                     R=3, roots=1)
            a1 = on_card(testing.admit_args(c1))
            k1 = dict(depth=c1["depth"])
            compare(name, a1, k1, stats)
            check(stats[name]["mismatches"] == 0, stats[name])
            t1 = time_kernel(name, a1, k1)
            extra["one_forest"] = dict(
                **{k: t1[k] for k in ("ms", "kernel_ms", "plain_ms",
                                      "bound_ms")},
                dependent_steps=flat_dependent_steps(a1, k1),
                shape=dict(N=int(a1[0].shape[0]), F=12, W=1000, heads=1000,
                           depth=k1["depth"]))
        if name == "admit_scan_preempt":
            # the perf-15k call timed above, and northstar-1k's
            # 1,000-gang cycle (the captured call with the most
            # preempting heads)
            def preempt_shape(a, k):
                pre = a[16] & (a[8] >= 0)
                return dict(N=int(a[0].shape[0]), F=int(a[0].shape[1]),
                            W=int(a[8].shape[0]), depth=k["depth"],
                            preempting=int(pre.sum()),
                            targets=int(((a[19] >= 0)
                                         & pre[:, None]).sum()),
                            tables=k.get("forest_of_node") is not None)
            extra["timed_shape"] = preempt_shape(args, kw)
            extra["device_ms_per_launch_on_path"] = per_launch(dc4, name)
            n_args, n_kw = max(cap.calls[("northstar", name)],
                               key=lambda c: int(c[0][16].sum()))
            tn = time_kernel(name, n_args, n_kw)
            extra["northstar_1000_gangs"] = dict(
                **{k: tn[k] for k in ("ms", "kernel_ms", "plain_ms",
                                      "bound_ms", "bound_by")},
                launches=launches5[name],
                device_ms_per_launch_on_path=per_launch(dc5, name),
                shape=preempt_shape(n_args, n_kw))
        if name == "drs_components":
            extra["timed_shape"] = dict(N=int(args[0].shape[0]),
                                        F=int(args[0].shape[1]),
                                        R=kw["n_resources"],
                                        depth=kw["depth"])
        if name == "burst_cycles":
            # the same timing on a perf-scenario window (5 forests)
            b_args, b_kw = burst_window(cap.calls[("bench_burst", name)])
            tb = time_kernel(name, b_args, b_kw)
            extra["bench_burst"] = dict(
                ms=tb["ms"], kernel_ms=tb["kernel_ms"],
                plain_ms=tb["plain_ms"],
                bound_ms=tb["bound_ms"], bound_by=tb["bound_by"],
                dependent_steps=burst_dependent_steps(b_kw),
                device_ms_per_launch_on_path=per_launch(dc7, name),
                shape=dict(C=int(b_args[0].shape[0]),
                           M=int(b_args[0].shape[1]), KC=b_kw["KC"],
                           K=b_kw["K"], L=b_kw["L"]))
            extra["dependent_steps"] = burst_dependent_steps(kw)
            extra["device_ms_per_launch_on_path"] = per_launch(dc8, name)
            # the worst case: one forest of every CQ (40 CQs, one block)
            o_args, o_kw = testing.burst_one_forest(0)
            o_args = [torch.from_numpy(a).cuda()
                      if isinstance(a, np.ndarray) else int(a)
                      for a in o_args]
            to = time_kernel(name, o_args, o_kw)
            extra["one_forest"] = dict(
                **{k: to[k] for k in ("ms", "kernel_ms", "plain_ms",
                                      "bound_ms")},
                dependent_steps=burst_dependent_steps(o_kw),
                shape=dict(C=40, L=o_kw["L"], KC=o_kw["KC"], K=o_kw["K"]))
            extra["sharded_northstar"] = dict(
                shards=NORTHSTAR_SHARDS,
                launches=launches15["burst_cycles"],
                device_ms_per_launch=per_launch(dc15, "burst_cycles"))
            extra["timed_shape"] = dict(C=int(args[0].shape[0]),
                                        M=int(args[0].shape[1]),
                                        KC=kw["KC"], K=kw["K"], L=kw["L"])
        rows.append(dict(
            name=name, route="cuda", source=SOURCE[name],
            replaces=TPU_KERNEL[name], launches=launches,
            max_abs_err=stats[name]["max_abs_err"], **t,
            cases=stats[name]["cases"],
            mismatches=stats[name]["mismatches"], path=phase,
            launches_by_phase={k: v[name] for k, v in by_phase.items()},
            **extra))
    print(json.dumps({"kernels": rows}), flush=True)
    log("[walls] s by phase, to each line from the one before: "
        + json.dumps({k: round(v, 3) for k, v in PHASE_WALLS.items()}))
    log(f"total {time.perf_counter() - t_start:.1f}s")
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
