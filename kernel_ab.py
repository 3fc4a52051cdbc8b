#!/usr/bin/env python3
"""Times the TAS descent kernels and fs_admit_scan of the kueue_tpu_torch
package under a checkout, on seeded inputs that every commit of the
port builds alike, so that two commits can be compared in one run on
one card (run it on each checkout in turns: parent, change, change,
parent).

    python3 kernel_ab.py CHECKOUT [LABEL]

Prints one JSON line: the card, and per case the ms per launch (CUDA
events around back-to-back launches behind a busy stream) and a digest
of the outputs:

- ``best_fit_descend`` / ``split_across_roots`` on tas-4k's tree
  (level sizes 8, 128, 4,096: runs of 16 and 32 children), R = 3,
  BestFit, a count that fits and one that does not;
- ``fs_admit_scan`` on ``testing.FS_SHAPES``' north-star row (1,000
  CQs, 200 cohorts, 1,024 heads, ~350 forests) and on one forest
  holding the 1,000 CQs and 200 cohorts (the worst case for a block
  per forest)."""

from __future__ import annotations

import inspect
import json
import os
import sys


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


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(sys.argv[1]))
    from kueue_tpu_torch import kernels
    from kueue_tpu_torch import testing as tt
    out = {"label": sys.argv[2] if len(sys.argv) > 2 else sys.argv[1],
           "device": torch.cuda.get_device_name(0),
           "library": str(kernels.build(force=True))}
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
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
