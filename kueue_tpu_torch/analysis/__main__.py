"""Run the AST invariant lint (``kueue_tpu_torch/analysis``) over the port.

Six passes, all stdlib-``ast``, no torch/numpy/jax import on the lint
path:

  purity       no host effects or syncs reachable from the launchers
  dtype        plane creations and launcher checks match PLANE_SCHEMA
  wal-order    journal append dominates the store mutation
  chaos-sites  doc / code / scenario site sets agree exactly
  env-flags    KUEUE_TPU_* reads go through features.ENV_FLAGS and
               match the README flag table
  metrics-doc  every emitted kueue_* series is documented

Findings not grandfathered in ``kueue_tpu_torch/analysis/baseline.json``
fail the lint (exit 1), as do *stale* baseline entries — the baseline
may only shrink.  Each entry carries the finding's line and message and
the reason it is kept.

Usage:
    python -m kueue_tpu_torch.analysis [paths ...]        # human output
    python -m kueue_tpu_torch.analysis --json             # machine output
    python -m kueue_tpu_torch.analysis --write-baseline   # grandfather
    python -m kueue_tpu_torch.analysis --artifact LINT.json

Default paths: kueue_tpu_torch/ chip_smoke.py kernel_ab.py (relative to
the repository root).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from . import (
    BASELINE_PATH,
    DEFAULT_PATHS,
    all_passes,
    apply_baseline,
    load_baseline,
    run_all,
)

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m kueue_tpu_torch.analysis",
        description="AST invariant lint for the kueue-tpu PyTorch/CUDA port")
    ap.add_argument("paths", nargs="*", default=list(DEFAULT_PATHS),
                    help="files/dirs to scan, relative to the repo root")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable findings on stdout")
    ap.add_argument("--baseline", default=BASELINE_PATH,
                    help="grandfathered-findings file")
    ap.add_argument("--write-baseline", action="store_true",
                    help="rewrite the baseline from this run's findings "
                         "(each entry keeps the reason it had)")
    ap.add_argument("--artifact", default=None,
                    help="also write a LINT_* artifact JSON here")
    args = ap.parse_args(argv)

    t0 = time.perf_counter()
    passes = all_passes()
    findings = run_all(_ROOT, args.paths, passes=passes)
    elapsed = time.perf_counter() - t0

    if args.write_baseline:
        prior = load_baseline(args.baseline)
        first = prior.get("first_full_run_findings") or len(findings)
        reasons: dict = {}
        for e in prior.get("entries", []):
            if isinstance(e, dict) and e.get("reason"):
                reasons[(e["key"], e.get("message"))] = e["reason"]
                reasons.setdefault(e["key"], e["reason"])
        payload = {
            "first_full_run_findings": first,
            "entries": [{"key": f.key, "line": f.line,
                         "message": f.message,
                         "reason": reasons.get((f.key, f.message),
                                               reasons.get(f.key, ""))}
                        for f in findings],
        }
        with open(args.baseline, "w", encoding="utf-8") as fh:
            json.dump(payload, fh, indent=2)
            fh.write("\n")
        print(f"baseline: {len(findings)} entries -> {args.baseline}")
        return 0

    baseline = load_baseline(args.baseline)
    unsuppressed, suppressed, stale = apply_baseline(findings, baseline)
    ok = not unsuppressed and not stale

    counts: dict[str, int] = {}
    for f in unsuppressed:
        counts[f.rule] = counts.get(f.rule, 0) + 1

    report = {
        "passes": [{"name": p.name, "doc": p.doc} for p in passes],
        "paths": list(args.paths),
        "findings": [f.to_json() for f in unsuppressed],
        "suppressed": [f.to_json() for f in suppressed],
        "stale_baseline": stale,
        "counts": counts,
        "total_findings": len(findings),
        "baseline_entries": len(baseline.get("entries", [])),
        "first_full_run_findings":
            baseline.get("first_full_run_findings", 0),
        "elapsed_s": round(elapsed, 3),
        "ok": ok,
    }

    if args.artifact:
        artifact = dict(report)
        artifact.update(metric="lint_unsuppressed_findings",
                        value=len(unsuppressed), unit="findings")
        with open(args.artifact, "w", encoding="utf-8") as fh:
            json.dump(artifact, fh, indent=2)
            fh.write("\n")

    if args.json:
        json.dump(report, sys.stdout, indent=2)
        print()
    else:
        for f in unsuppressed:
            print(f.render())
        for key in stale:
            print(f"stale baseline entry (violation is gone — delete "
                  f"it): {key}")
        print(f"lint: {len(passes)} passes, {len(findings)} findings "
              f"({len(suppressed)} grandfathered, "
              f"{len(unsuppressed)} new, {len(stale)} stale baseline) "
              f"in {elapsed:.2f}s")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
