"""North-star probe: classify 100k pending workloads against 1k
ClusterQueues in one device call, then run the admit scan over the 1k
cycle heads, flat and forest-parallel (the JAX package's
``scripts/northstar_probe.py``).

    python -m kueue_tpu_torch.probe [W] [C] [--device cpu] [--reps N]

Runs on the card unless ``--device cpu`` is given (the plain PyTorch
versions); without a GPU and without ``--device cpu`` it raises.  Each
of the three timings is the p50 and the worst of ``reps`` calls after
one warm-up, on the host clock from host numpy arrays in to results
ready (the upload included, as the JAX script's ``bench_fn`` times a
jitted call on numpy inputs).  Kernel launches record no timing events;
the kernels' device time is read by ``profiling.DeviceClock`` around a
run (``chip_smoke.py`` phase 13 does so).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from .ops import cycle
from .ops.solver import resolve_device
from .scenarios import probe_synth

COHORTS = 64


def probe_calls(W: int = 100_000, C: int = 1_000, cohorts: int = COHORTS):
    """The probe's three calls: [(label, solver name, numpy args,
    keyword arguments)] — the classify of W heads against C CQs
    (``run_scan=False``), the flat C-head scan, and the forest scan over
    ``cohorts`` forests with ``max_forest_wl`` = the largest forest + 1."""
    args, depth = probe_synth(W=W, C=C, cohorts=cohorts)
    heads_args, _ = probe_synth(W=C, C=C, cohorts=cohorts, seed=1)
    forest_of_node = np.concatenate([
        heads_args[5][:C] - C,                     # CQ → its cohort index
        np.arange(cohorts, dtype=np.int32)]).astype(np.int32)
    heads_cq = np.maximum(heads_args[10], 0)
    max_group = int(np.bincount(forest_of_node[heads_cq],
                                minlength=cohorts).max())
    return [
        ("classify", "solve_cycle", args,
         dict(depth=depth, run_scan=False)),
        ("flat", "solve_cycle", heads_args,
         dict(depth=depth, run_scan=True)),
        ("forest", "solve_cycle_forests", heads_args + (forest_of_node,),
         dict(depth=depth, n_forests=cohorts, max_forest_wl=max_group + 1)),
    ]


def _upload(arrays, dev):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in arrays]


def bench_fn(fn, reps: int = 20):
    """(p50 s, worst s, last output) of ``reps`` calls after a warm-up;
    every call ends with its results ready."""
    out = fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2], times[-1], out


def run(W: int = 100_000, C: int = 1_000, device="cuda", reps: int = 20,
        cohorts: int = COHORTS) -> dict:
    """The three timings → {label: dict(p50_ms, worst_ms, calls,
    outputs as tensors on the device)}."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    results = {}
    for label, name, args, kw in probe_calls(W, C, cohorts):
        fn = getattr(cycle, name)

        def call():
            out = fn(*_upload(args, dev), **kw)
            if on_card:
                torch.cuda.synchronize(dev)
            return out

        p50, worst, out = bench_fn(call, reps)
        results[label] = dict(
            p50_ms=p50 * 1e3, worst_ms=worst * 1e3, calls=reps + 1,
            outputs=out, name=name, kw=kw)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("W", type=int, nargs="?", default=100_000)
    ap.add_argument("C", type=int, nargs="?", default=1_000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=20)
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu (plain PyTorch versions)")
    print(f"device: {name}; W={a.W} C={a.C}", flush=True)
    r = run(a.W, a.C, dev, a.reps)

    def line(label, what):
        x = r[label]
        print(f"{what}: p50={x['p50_ms']:.3f}ms worst={x['worst_ms']:.3f}ms",
              flush=True)

    fit = int((r["classify"]["outputs"][4] >= 0).sum())
    line("classify", f"phase-1 classify {a.W}x{a.C} ({fit} fits)")
    line("flat", f"flat {a.C}-head admit scan")
    mfw = r["forest"]["kw"]["max_forest_wl"]
    line("forest", f"forest-parallel admit scan ({COHORTS} forests, {mfw} "
                   f"steps)")
    total = r["classify"]["p50_ms"] + r["forest"]["p50_ms"]
    print(f"north-star cycle (classify backlog + admit heads): "
          f"{total:.3f}ms  (target <1000ms)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
