#!/usr/bin/env python3
"""Smoke run of kueue_tpu_torch on one NVIDIA GPU.

Builds the CUDA kernels from the sources in this checkout, holds every
kernel against its plain PyTorch version, and drives the port's main path
at full size both ways: ``Driver(device="cuda").schedule_once`` per cycle
and ``Driver.schedule_burst``, K cycles per launch; then fair-sharing
admission, ``Driver(device="cuda", fair_sharing=True).schedule_once``;
then topology-aware scheduling, ``Driver(device="cuda")`` with the TAS
gates on:

1. device: name, count and ``nvidia-smi`` name/power limit;
2. build: nvcc of every kernel source (in parallel) into one library;
3. kernels: each CUDA kernel against its plain version on the CPU over a
   seeded sweep (kueue_tpu_torch.testing.kernel_cases, burst_cases and
   fs_cases) and over the inputs captured from the first calls of phases
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
   4,096-root level, the sort in global memory) and the calls captured
   in phase 11 — exact in values and dtypes.

Launch counts are zeroed just before phases 4, 5, 7, 8, 9, 9b and 11 and
read just after each.  Prints a ``kernels`` JSON line (per kernel: its launches on
its main path and in each phase), the nvidia-smi line, and as its last
line ``{"ok": true, "device": {...}}``.  Exits non-zero, with no result
line, when there is no CUDA device or no kueue_tpu_torch beside it.

    python3 chip_smoke.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

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
}
TAS_KERNELS = ("fill_counts", "best_fit_descend", "split_across_roots")
BENCH_WORKLOADS = 15_000
NORTHSTAR = dict(n_cqs=1000, n_wl=100_000, cycles=30)
KIND_PREEMPT = 4            # ops/burst.py decision code
PARITY_SCALE = 0.2          # 3,000 workloads
TAS_CYCLES = 60             # tas-4k, on the card, on the CPU and walked


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok, what) -> None:
    """A phase's requirement; failing it fails the run."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


class Capture:
    """Wraps the solver's kernel entry points to keep the inputs of the
    first ``keep`` calls of each kernel in each phase (references only:
    the kernels do not write their inputs).  The wrapped function itself
    is called unchanged."""

    def __init__(self, keep: int = 4):
        self.keep = keep
        self.phase = ""
        self.calls: dict[tuple[str, str], list] = {}
        self._undo = []

    def install(self, module, attr: str, name: str) -> None:
        fn = getattr(module, attr)

        def wrapped(*args, **kw):
            calls = self.calls.setdefault((self.phase, name), [])
            out = fn(*args, **kw)
            if len(calls) < self.keep:
                calls.append((args, kw))
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
    return {
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
    return {k: v for k, v in kw.items() if k != "device"}


def compare(name, args, kw, stats) -> None:
    """One CUDA launch against the plain version on CPU copies."""
    import torch
    cuda = as_tuple(cuda_fns()[name](*args, **cuda_kw(kw)))
    plain = as_tuple(plain_fns()[name](*on_cpu(args), **plain_kw(kw)))
    torch.cuda.synchronize()
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


def tas_dependent_steps(name, args, kw) -> int:
    """The launch's chain of dependent steps: the fill's L barriers, the
    bitonic sort's log2(P) (log2(P) + 1) / 2 barriers and three more per
    level walked, and each level's longest child walk (three passes
    under BestFit)."""
    import numpy as np
    sizes = kw["level_sizes"]
    steps = len(sizes)
    for d in tas_levels(name, kw):
        lg = max(0, (sizes[d] - 1).bit_length())
        if d == 0:
            seg = sizes[0]
        else:
            par = args[2][d - 1].cpu().numpy()
            seg = int(np.bincount(par, minlength=sizes[d - 1]).max())
        steps += lg * (lg + 1) // 2 + 3 + 3 * seg
    return steps


def op_count(name, args, kw) -> int:
    """int32 operations the call's data needs: ~12 per column per chain
    step of each entry that runs (admit scans: valid heads; preempt:
    plus the target removals and the check-plane copy; search: valid
    searches x real candidates x the forward and reverse steps)."""
    if name in TAS_KERNELS:
        return tas_op_count(name, args, kw)
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
        pre = int(args[16].sum())
        mt = args[19].shape[1]
        ops += pre * (N * F + mt * depth * F * 12)
    return int(ops)


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


def time_kernel(name, args, kw, reps: int = 50) -> dict:
    """Mean device ms per launch (CUDA events around ``reps`` launches
    queued behind a busy stream), the plain version's ms on the same
    card-resident inputs (host clock, synchronized), and the bound of
    the call: the larger of its bytes over HBM bandwidth and its int32
    operations over the peak rate."""
    import torch
    from kueue_tpu_torch import kernels
    fn = cuda_fns()[name]
    kw_c = cuda_kw(kw)
    outs = as_tuple(fn(*args, **kw_c))
    for _ in range(3):
        fn(*args, **kw_c)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # hold the stream busy while the host enqueues every launch, so the
    # events bracket the kernels back to back and not the host's
    # launch overhead between them
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(reps):
        fn(*args, **kw_c)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / reps
    kernels.collect()
    plain = plain_fns()[name]
    plain(*args, **plain_kw(kw))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain(*args, **plain_kw(kw))
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    bytes_ms = io_bytes(args, outs) / PEAK_BYTES_PER_S * 1e3
    ops_ms = op_count(name, args, kw) / PEAK_OPS_PER_S * 1e3
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                library_ms=None)


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


def largest(calls):
    """The captured call with the most heads (admit scans, [N, F] usage)
    or searches (the batched search, [S, NL, F] usage)."""
    def size(call):
        args = call[0]
        return args[0].shape[0] if args[0].dim() == 3 else args[8].shape[0]
    return max(calls, key=size)


def deepest(calls):
    """The captured best_fit_descend call that walks the most levels."""
    return min(calls, key=lambda call: call[1]["level"])


def burst_window(calls):
    """The captured burst window to time: the last one kept, which is a
    window with preemption whenever the phase had one."""
    return calls[-1]


def burst_line(tag, d, r, launches) -> None:
    from kueue_tpu_torch import scenarios
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
        f"{json.dumps(scenarios.burst_boundary_report(bs))}; launches "
        f"{json.dumps(launches)}")


def main() -> int:
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

    # -- 3a. kernels against their plain versions: seeded sweep ------------
    stats = {k: dict(cases=0, mismatches=0, max_abs_err=0)
             for k in kernels.KERNELS}
    for seed in (0, 1):
        for name, arrays, kw in testing.kernel_cases(seed):
            args = [torch.from_numpy(a).cuda() for a in arrays]
            compare(name, args, kw, stats)
        for _, arrays, kw in testing.burst_cases(seed):
            args = [torch.from_numpy(a).cuda() if isinstance(a, np.ndarray)
                    else int(a) for a in arrays]
            compare("burst_cycles", args, kw, stats)
        for name, arrays, kw in testing.fs_cases(seed):
            compare(name, [torch.from_numpy(a).cuda() for a in arrays], kw,
                    stats)
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
    r = scenarios.run_bench(d, clock, total, waves)
    torch.cuda.synchronize()
    launches4 = dict(kernels.LAUNCHES)
    device_ms4 = kernels.collect()
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
        f"device_ms {json.dumps(device_ms4)}")
    check(r["finished"] == r["total"] == BENCH_WORKLOADS, r["finished"])
    check(r["preempted"] > 0, "no preemption in the perf scenario")
    check(ss["host_cycles"] == 0, ss)
    for k in ("admit_scan", "admit_scan_preempt",
              "minimal_preemptions_batch"):
        check(launches4[k] > 0, (k, launches4))
    del d, waves

    # -- 5. the north-star shape, per cycle ---------------------------------
    cap.phase = "northstar"
    t0 = time.perf_counter()
    d, clock, total, wave = scenarios.build_northstar(
        NORTHSTAR["n_cqs"], NORTHSTAR["n_wl"], device="cuda")
    d.scheduler.solver.warmup(d.cache.snapshot(), NORTHSTAR["n_cqs"])
    build_s = time.perf_counter() - t0
    kernels.reset_counts()
    r5 = scenarios.run_northstar(d, clock, wave, cycles=NORTHSTAR["cycles"])
    torch.cuda.synchronize()
    launches5 = dict(kernels.LAUNCHES)
    device_ms5 = kernels.collect()
    log(f"[5 northstar] {NORTHSTAR['n_cqs']} CQs, {total} workloads "
        f"(built in {build_s:.1f}s), {r5['cycles']} cycles in "
        f"{r5['wall']:.2f}s, cycle p50 "
        f"{scenarios.percentile(r5['cycle_times'], 0.5) * 1e3:.3f}ms p99 "
        f"{scenarios.percentile(r5['cycle_times'], 0.99) * 1e3:.3f}ms, "
        f"admitted {r5['admitted']}, preempted {r5['preempted']}; "
        f"launches {json.dumps(launches5)}; device_ms "
        f"{json.dumps(device_ms5)}")
    check(launches5["admit_scan_forests"] > 0, launches5)
    del d
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
    check(digests["cuda"] == digests["cpu"], digests)

    # -- 7. the perf scenario through the fused burst -------------------------
    install_capture(cap)
    cap.phase = "bench_burst"
    d, clock, total, waves = scenarios.build_bench(
        BENCH_WORKLOADS / 15_000, device="cuda")
    d.scheduler.solver.warmup(d.cache.snapshot(),
                              len(d.cache.cluster_queue_names()))
    kernels.reset_counts()
    r7 = scenarios.drain_bench_burst(d, clock, total, waves)
    torch.cuda.synchronize()
    launches7 = dict(kernels.LAUNCHES)
    device_ms7 = kernels.collect()
    log(f"[7 bench burst] drained {r7['finished']}/{r7['total']} in "
        f"{r7['cycles']} cycles, {r7['wall']:.2f}s wall, "
        f"{r7['finished'] / r7['wall']:.1f} admissions/s, cycle p50 "
        f"{scenarios.percentile(r7['cycle_times'], 0.5) * 1e3:.3f}ms p99 "
        f"{scenarios.percentile(r7['cycle_times'], 0.99) * 1e3:.3f}ms, "
        f"preempted {r7['preempted']}, digest "
        f"{scenarios.decision_digest(d, r7['decisions'])}; device_ms "
        f"{json.dumps(device_ms7)}")
    burst_line("7 bench burst", d, r7, launches7)
    check(r7["finished"] == r7["total"] == BENCH_WORKLOADS, r7["finished"])
    check(launches7["burst_cycles"] > 0, launches7)
    check(d._burst_solver.stats["burst_cycles_decided"] > 0, "no burst")
    del d, waves
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
    check(digests["cuda"] == digests["cpu"], digests)

    # -- 8. the north-star shape through the fused burst ---------------------
    install_capture(cap)
    cap.phase = "northstar_burst"
    t0 = time.perf_counter()
    d, clock, total, wave = scenarios.build_northstar(
        NORTHSTAR["n_cqs"], NORTHSTAR["n_wl"], device="cuda")
    d.scheduler.solver.warmup(d.cache.snapshot(), NORTHSTAR["n_cqs"])
    build_s = time.perf_counter() - t0
    kernels.reset_counts()
    r8 = scenarios.northstar_burst(d, clock, wave,
                                   cycles=NORTHSTAR["cycles"])
    torch.cuda.synchronize()
    launches8 = dict(kernels.LAUNCHES)
    device_ms8 = kernels.collect()
    log(f"[8 northstar burst] {NORTHSTAR['n_cqs']} CQs, {total} workloads "
        f"(built in {build_s:.1f}s), {r8['cycles']} cycles in "
        f"{r8['wall']:.2f}s, cycle p50 "
        f"{scenarios.percentile(r8['cycle_times'], 0.5) * 1e3:.3f}ms p99 "
        f"{scenarios.percentile(r8['cycle_times'], 0.99) * 1e3:.3f}ms, "
        f"admitted {r8['admitted']}, preempted {r8['preempted']}, digest "
        f"{scenarios.decision_digest(d, r8['decisions'])}; device_ms "
        f"{json.dumps(device_ms8)}")
    burst_line("8 northstar burst", d, r8, launches8)
    check(r8["cycles"] == NORTHSTAR["cycles"], r8["cycles"])
    check(launches8["burst_cycles"] > 0, launches8)
    check(r8["preempted"] > 0, "no preemption in the north-star wave")
    del d
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
    r9 = scenarios.run_northstar_fs(d, clock, cycles=NORTHSTAR["cycles"])
    snapshot = d.cache.snapshot()
    t_drs = time.perf_counter()
    drs = compute_all_drs(snapshot, device="cuda")
    drs_s = time.perf_counter() - t_drs
    torch.cuda.synchronize()
    launches9 = dict(kernels.LAUNCHES)
    device_ms9 = kernels.collect()
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
        f"{ss['host_cycles']}; digest {digest9}; launches "
        f"{json.dumps(launches9)}; device_ms {json.dumps(device_ms9)}")
    check(launches9["fs_admit_scan"] > 0, launches9)
    check(ss["fs_full_cycles"] > 0, ss)
    check(r9["admitted"] > 0, "nothing admitted")
    host = host_drs(snapshot)
    log(f"[9 compute_all_drs] {len(drs)} nodes in {drs_s * 1e3:.3f}ms, "
        f"{sum(v > 0 for v in host.values())} borrowing, equal to the "
        f"host: {drs == host}")
    check(drs == host, "compute_all_drs differs from the host DRS")
    check(launches9["drs_components"] > 0, launches9)
    del d, snapshot

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
    kernels.collect()
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
        with scenarios.TASBranches() as br11:
            r11 = scenarios.run_tas(d, clock, runtimes, cycles=TAS_CYCLES)
        torch.cuda.synchronize()
        launches11 = dict(kernels.LAUNCHES)
        device_ms11 = kernels.collect()
    cap.uninstall()
    digest11 = scenarios.tas_digest(d, r11)
    ss = d.scheduler.solver.stats
    wall11 = sum(r11["cycle_times"])
    dev11 = sum(device_ms11.values()) / 1e3
    log(f"[11 tas-4k] {len(d.cache.tas.nodes)} nodes, {len(runtimes)} "
        f"workloads (built in {build_s:.1f}s), {r11['cycles']} cycles in "
        f"{r11['wall']:.2f}s, cycle p50 "
        f"{scenarios.percentile(r11['cycle_times'], 0.5) * 1e3:.3f}ms p99 "
        f"{scenarios.percentile(r11['cycle_times'], 0.99) * 1e3:.3f}ms, "
        f"admitted {r11['admitted']}; branches {json.dumps(br11.counts)}; "
        f"full_cycles {ss['full_cycles']}, scalar_heads "
        f"{ss['scalar_heads']}, host_cycles {ss['host_cycles']}; device "
        f"{dev11 * 1e3:.3f}ms of {wall11 * 1e3:.3f}ms cycle wall (host "
        f"share {1 - dev11 / wall11:.4f}); digest {digest11}; launches "
        f"{json.dumps(launches11)}; device_ms {json.dumps(device_ms11)}")
    check(r11["admitted"] > 0, "tas-4k admitted nothing")
    for name in TAS_KERNELS:
        check(launches11[name] > 0, (name, launches11))
        check(launches11[name] == br11.counts[name],
              (name, "launches differ from calls", launches11, br11.counts))
    for branch in scenarios.TASBranches.BRANCHES:
        check(br11.counts[branch] > 0, (branch, br11.counts))
    check(br11.counts["scalar_walk"] == 0, "the host walk ran on the card")
    check(launches11["admit_scan"] > 0, launches11)
    del d

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
    check(kernels.LAUNCHES == before, "a CPU run launched a kernel")

    # -- 3e. the TAS kernels: seeded sweep, global-memory sort, captured -----
    for seed in (0, 1):
        for name, arrays, kw in testing.tas_cases(
                seed, testing.TAS_PARTS + ("tas4k",), flat=4096):
            compare(name, on_card(arrays), kw, stats)
    smem_sort = kernels.TAS_SMEM_SORT
    kernels.TAS_SMEM_SORT = 0
    try:
        for name, arrays, kw in testing.tas_cases(0, ("three_levels",
                                                      "flat")):
            if name != "fill_counts":
                compare(name, on_card(arrays), kw, stats)
    finally:
        kernels.TAS_SMEM_SORT = smem_sort
    n_captured = 0
    for name in TAS_KERNELS:
        for args, kw in cap.calls.get(("tas", name), []):
            compare(name, args, kw, stats)
            n_captured += 1
    for name, s in stats.items():
        check(s["mismatches"] == 0, (name, s))
    log(f"[3 kernels, TAS sweep + {n_captured} captured] "
        f"{json.dumps({k: stats[k] for k in TAS_KERNELS})}")

    # -- the kernels line ----------------------------------------------------
    by_phase = {"4": launches4, "5": launches5, "7": launches7,
                "8": launches8, "9": launches9, "9b": launches9b,
                "11": launches11}
    rows = []
    for name in kernels.KERNELS:
        phase = {"admit_scan_forests": "northstar",
                 "burst_cycles": "northstar_burst",
                 "fs_admit_scan": "northstar_fs",
                 "drs_components": "northstar_fs",
                 **dict.fromkeys(TAS_KERNELS, "tas")}.get(name, "bench")
        calls = cap.calls.get((phase, name))
        check(calls, f"{name}: no captured {phase} call")
        args, kw = (burst_window(calls) if name == "burst_cycles"
                    else most_heads(calls) if name == "fs_admit_scan"
                    else deepest(calls) if name == "best_fit_descend"
                    else calls[0] if name in ("drs_components",
                                              "fill_counts",
                                              "split_across_roots")
                    else largest(calls))
        t = time_kernel(name, args, kw)
        launches = {"northstar": launches5, "bench": launches4,
                    "northstar_burst": launches8,
                    "northstar_fs": launches9, "tas": launches11}[phase][name]
        extra = {}
        if name in TAS_KERNELS:
            extra["dependent_steps"] = tas_dependent_steps(name, args, kw)
            extra["timed_shape"] = dict(
                level_sizes=list(kw["level_sizes"]),
                R=int(args[0].shape[1]),
                **{k: kw[k] for k in ("level", "profile", "descend_profile")
                   if k in kw})
            extra["device_ms_per_launch_on_path"] = (
                device_ms11[name] / max(1, launches11[name]))
        if name == "fs_admit_scan":
            # the dependent chain: every live round is 5 + 7 (n_levels - 1)
            # block barriers (fs_admit_scan.cu)
            rounds, entry_rounds, node_rounds = fs_forest_work(args)
            extra["dependent_steps"] = rounds * (
                5 + 7 * (kw["n_levels"] - 1))
            extra["timed_shape"] = dict(
                N=int(args[0].shape[0]), F=int(args[0].shape[1]),
                W=int(args[12].shape[0]), heads=rounds,
                depth=kw["depth"], n_levels=kw["n_levels"])
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
                ms=tb["ms"], plain_ms=tb["plain_ms"],
                bound_ms=tb["bound_ms"], bound_by=tb["bound_by"],
                dependent_steps=b_kw["K"] * b_kw["L"],
                shape=dict(C=int(b_args[0].shape[0]),
                           M=int(b_args[0].shape[1]), KC=b_kw["KC"],
                           K=b_kw["K"], L=b_kw["L"]))
            # the dependent chain of one launch: K cycles of L scan steps
            # (plus the candidates each search walks, data-dependent)
            extra["dependent_steps"] = kw["K"] * kw["L"]
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
    log(f"total {time.perf_counter() - t_start:.1f}s")
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
