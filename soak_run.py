#!/usr/bin/env python3
"""One of the traffic, serving, federation and distributed soak twins or
the roofline twin on one GPU, with what the card saw: ``python -m
kueue_tpu_torch.traffic_soak`` / ``serve_soak`` / ``federation_soak`` /
``dist_soak`` / ``accel_roofline`` through its ``run`` under the
profiler.

    python3 soak_run.py traffic|serve|federation|dist|roofline
        [TWIN FLAGS...] [--tail PATH]

The twin's own flags pass through (``--quick``, ``--cqs``, ...; its
Drivers on ``--torch-device cuda``).  Prints the ``nvidia-smi`` name and
power limit, then one JSON object as the last line of stdout: the
twin's metric and headline value, the run's wall, every kernel's
launches in this process and, from the profiler
(``profiling.DeviceClock``), each kernel's device ms, the busy union and
its share of the wall, what the run decided (the twin's ``decided``),
the twin's ``headline`` and ``children`` where it has them (the dist
twin's children: each one's start, CUDA context and launches, from its
``--stats-file``), and the problems the port's copy of the validator's
checks finds in its tail, with the twin's own ``check`` of what ``run``
recorded (the roofline: every card output against the plain
version's).  ``--tail`` writes the whole tail there.  Needs a CUDA
device.
"""

from __future__ import annotations

import importlib
import inspect
import json
import subprocess
import sys
import time

#: twin -> (module, the record name its checks are run under)
TWINS = {"traffic": ("traffic_soak", "TRAFFIC_r21.json"),
         "serve": ("serve_soak", "SERVE_r21.json"),
         "federation": ("federation_soak", "FED_r21.json"),
         "dist": ("dist_soak", "DIST_r22.json"),
         "roofline": ("accel_roofline", "ROOFLINE_r22.json")}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in TWINS:
        print(__doc__, file=sys.stderr)
        return 2
    name, rest = argv[0], argv[1:]
    tail_path = None
    if "--tail" in rest:
        i = rest.index("--tail")
        tail_path = rest[i + 1]
        del rest[i:i + 2]
    import torch
    if not torch.cuda.is_available():
        print("soak_run: no CUDA device", file=sys.stderr)
        return 2
    from kueue_tpu_torch import kernels
    from kueue_tpu_torch.perf.validate import validate_tail
    from kueue_tpu_torch.profiling import DeviceClock
    module, record_name = TWINS[name]
    mod = importlib.import_module(f"kueue_tpu_torch.{module}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    t0 = time.perf_counter()
    kernels.load()
    build_s = time.perf_counter() - t0
    args = mod.parser().parse_args(rest + ["--torch-device", "cuda"])
    record: dict = {}
    takes_record = "record" in inspect.signature(mod.run).parameters
    kernels.reset_counts()
    t0 = time.perf_counter()
    with DeviceClock() as dc:
        tail = mod.run(args, record) if takes_record else mod.run(args)
    wall = time.perf_counter() - t0
    out = {
        "twin": module, "argv": rest, "nvidia_smi": smi,
        "device": torch.cuda.get_device_name(0),
        "kernel_build_s": round(build_s, 2),
        "metric": tail["metric"], "value": tail.get("value"),
        "wall_s": round(wall, 2),
        "launches": {k: v for k, v in kernels.LAUNCHES.items() if v},
        "device_kernel_ms": {k: round(v, 3) for k, v in dc.kernel_ms.items()
                             if v},
        "device_other_ms": round(dc.other_ms, 3),
        "device_busy_ms": round(dc.busy_ms, 3),
        "busy_share": dc.busy_ms / 1e3 / wall,
        "decided": mod.decided(tail),
        "problems": validate_tail(tail, record_name) + (
            mod.check(record) if hasattr(mod, "check") else []),
    }
    for extra in ("headline", "children"):
        if hasattr(mod, extra):
            out[extra] = getattr(mod, extra)(tail, record)
    if tail_path:
        with open(tail_path, "w") as fh:
            json.dump(tail, fh, indent=1)
            fh.write("\n")
    print(json.dumps(out), flush=True)
    return 0 if not out["problems"] else 1


if __name__ == "__main__":
    sys.exit(main())
