#!/usr/bin/env python3
"""The scale soak's row-ceiling probe at full width on one GPU: the twin's
``scale_soak.ceiling_probe`` (``python -m kueue_tpu_torch.scale_soak``
runs it at ``--ceiling-cqs``) alone, with what the card saw.

    python3 ceiling_run.py [--cqs 1052672] [--preempt-cohorts 1024]
        [--seed 1307] [--out PATH]

Prints the ``nvidia-smi`` name and power limit, the probe's block (build
and preload seconds, the head-packed and row-backed pack times, the
round's wall, host RSS), the card's peak allocated memory, every kernel's
launches and, from the profiler (``profiling.DeviceClock``), each
kernel's device ms over the probe; the JSON object is the last line of
stdout (also written to ``--out``).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cqs", type=int, default=1_052_672)
    ap.add_argument("--preempt-cohorts", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=1307)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("ceiling_run: no CUDA device", file=sys.stderr)
        return 2
    from kueue_tpu_torch import kernels, scale_soak
    from kueue_tpu_torch.profiling import DeviceClock
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    t0 = time.perf_counter()
    kernels.load()
    build_kernels_s = time.perf_counter() - t0
    kernels.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with DeviceClock() as dc:
        block = scale_soak.ceiling_probe(args.cqs, args.preempt_cohorts,
                                         args.seed, device="cuda")
    out = {
        "nvidia_smi": smi,
        "device": torch.cuda.get_device_name(0),
        "kernel_build_s": round(build_kernels_s, 2),
        "probe_s": round(time.perf_counter() - t0, 1),
        "ceiling": block,
        "card_peak_allocated_mb": round(
            torch.cuda.max_memory_allocated() / 2**20, 1),
        "launches": {k: v for k, v in kernels.LAUNCHES.items() if v},
        "device_kernel_ms": {k: round(v, 3) for k, v in dc.kernel_ms.items()
                             if v},
        "device_busy_ms": round(dc.busy_ms, 3),
    }
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
            fh.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
