"""The port's copy of ``scripts/validate_artifacts.py``'s checks of the
soak tails it writes (``CHAOS_*``, ``OBS_*``, ``SCALE_*``, ``TRAFFIC_*``,
``FED_*``, ``SERVE_*``, ``DIST_*``): the chip smoke run holds the twins'
tails to them without importing ``scripts/``, and
``tests/test_torch_soak_checks`` holds each function here equal to the
script's, line for line.

``validate_tail(tail, name)`` runs the checks ``validate`` runs on a file
of that ``name`` holding ``tail`` → the list of violations.
"""

from __future__ import annotations

import os
import re


def _err(out, path, msg):
    out.append(f"{os.path.basename(path)}: {msg}")


def _check_common(d, path, out):
    if not isinstance(d, dict) or not d:
        _err(out, path, "top level must be a non-empty JSON object")
        return False
    if "metric" in d and not isinstance(d["metric"], str):
        _err(out, path, "'metric' must be a string")
    if "value" in d and d["value"] is not None \
            and not isinstance(d["value"], (int, float)):
        _err(out, path, "'value' must be a number or null")
    if "unit" in d and not isinstance(d["unit"], str):
        _err(out, path, "'unit' must be a string")
    if "cqs" in d and not isinstance(d["cqs"], int):
        _err(out, path, "'cqs' must be an int")
    mesh = d.get("mesh")
    if mesh is not None:
        if not isinstance(mesh, dict):
            _err(out, path, "'mesh' must be an object")
        else:
            if not isinstance(mesh.get("n_devices"), int):
                _err(out, path, "'mesh.n_devices' must be an int")
            if not isinstance(mesh.get("platform"), str):
                _err(out, path, "'mesh.platform' must be a string")
    return True


def _check_chaos(d, path, out):
    scenarios = d.get("scenarios")
    if not isinstance(scenarios, dict) or not scenarios:
        _err(out, path, "'scenarios' must be a non-empty object")
        return
    n_ran = n_stable = 0
    for name, s in scenarios.items():
        if not isinstance(s, dict):
            _err(out, path, f"scenario '{name}' must be an object")
            continue
        if s.get("skipped"):
            if not isinstance(s.get("reason"), str):
                _err(out, path, f"skipped scenario '{name}' needs a "
                     "'reason' string")
            continue
        n_ran += 1
        if not isinstance(s.get("decisions_stable"), bool):
            _err(out, path, f"scenario '{name}' missing bool "
                 "'decisions_stable'")
            continue
        if not isinstance(s.get("failures"), list):
            _err(out, path, f"scenario '{name}' missing 'failures' list")
        if s["decisions_stable"]:
            n_stable += 1
            if s.get("failures"):
                _err(out, path, f"scenario '{name}' claims stable but "
                     f"lists failures: {s['failures'][:2]}")
    if not isinstance(d.get("all_stable"), bool):
        _err(out, path, "missing bool 'all_stable'")
    elif d["all_stable"] != (n_ran > 0 and n_stable == n_ran):
        _err(out, path, f"'all_stable'={d['all_stable']} inconsistent "
             f"with {n_stable}/{n_ran} stable scenarios")
    if d.get("scenarios_total") != n_ran:
        _err(out, path, f"'scenarios_total'={d.get('scenarios_total')} "
             f"but {n_ran} scenarios ran")
    if d.get("scenarios_stable") != n_stable:
        _err(out, path, f"'scenarios_stable'={d.get('scenarios_stable')} "
             f"but {n_stable} verdicts are stable")


def _check_metric_value(d, path, out):
    if not isinstance(d.get("metric"), str):
        _err(out, path, "missing string 'metric'")
    if not isinstance(d.get("value"), (int, float)):
        _err(out, path, "missing numeric 'value'")


def _check_scale(d, path, out):
    """SCALE_* scaling-law artifacts (scripts/scale_soak.py): the
    per-universe-size curve (streaming vs rebuild host pack ms measured
    on the same state, end-to-end cycle cost, bytes-to-device, RSS,
    per-size parity verdicts), the all-sizes parity booleans, the
    completed high-count workload soak, and the interleaved same-box
    control arm."""
    curve = d.get("curve")
    if not isinstance(curve, list) or not curve:
        _err(out, path, "'curve' must be a non-empty list of sizes")
        curve = []
    for e in curve:
        if not isinstance(e, dict):
            _err(out, path, "'curve' entries must be objects")
            continue
        n = e.get("cqs")
        if not isinstance(n, int) or n < 1:
            _err(out, path, "'curve' entry missing int 'cqs' >= 1")
            continue
        for k in ("pack_ms_stream", "pack_ms_rebuild",
                  "cycle_wall_ms", "rss_mb"):
            if not isinstance(e.get(k), (int, float)):
                _err(out, path, f"'curve' size {n}: missing numeric "
                     f"'{k}'")
        for k in ("bytes_to_device", "bytes_to_device_raw"):
            if not isinstance(e.get(k), int):
                _err(out, path, f"'curve' size {n}: missing int '{k}'")
        for k in ("planes_identical", "decisions_identical"):
            if not isinstance(e.get(k), bool):
                _err(out, path, f"'curve' size {n}: missing bool '{k}'")
    parity = d.get("parity")
    if not isinstance(parity, dict):
        _err(out, path, "'parity' must be an object")
    else:
        for k in ("planes_identical_all", "decisions_identical_all"):
            v = parity.get(k)
            if not isinstance(v, bool):
                _err(out, path, f"'parity.{k}' must be a bool")
            elif curve and all(isinstance(e, dict) for e in curve):
                per = k.rsplit("_", 1)[0]
                got = all(e.get(per) is True for e in curve)
                if v != got:
                    _err(out, path, f"'parity.{k}'={v} inconsistent "
                         "with the per-size verdicts")
    soak = d.get("soak")
    if not isinstance(soak, dict):
        _err(out, path, "'soak' must be an object")
    else:
        for k in ("target_workloads", "created", "admitted", "rounds"):
            if not isinstance(soak.get(k), int):
                _err(out, path, f"'soak.{k}' must be an int")
        done = soak.get("completed")
        if not isinstance(done, bool):
            _err(out, path, "'soak.completed' must be a bool")
        elif isinstance(soak.get("created"), int) \
                and isinstance(soak.get("target_workloads"), int) \
                and done != (soak["created"] >= soak["target_workloads"]):
            _err(out, path, f"'soak.completed'={done} inconsistent with "
                 f"created={soak['created']} vs "
                 f"target={soak['target_workloads']}")
    control = d.get("control")
    if not isinstance(control, dict) \
            or control.get("interleaved") is not True:
        _err(out, path, "'control' must be an object with "
             "interleaved=true (same-box environment-drift arm)")
    rnd = re.match(r"SCALE_R(\d+)", os.path.basename(path).upper())
    if rnd and int(rnd.group(1)) >= 18:
        _check_scale_r18(d, path, out, curve)
    if rnd and int(rnd.group(1)) >= 19:
        _check_scale_r19(d, path, out)


def _check_scale_r18(d, path, out, curve):
    """SCALE_r18+ (scripts/scale_soak.py, ISSUE 16): the classic
    (all-scale-optimizations-off) bit-identity arm per size, the lifted
    row ceiling, the aggregate/heap/wal_shard measurement blocks, and
    the machine-readable residue ledger with named walls."""
    for e in curve:
        if not isinstance(e, dict) or not isinstance(e.get("cqs"), int):
            continue
        n = e["cqs"]
        if not isinstance(e.get("decisions_identical_classic"), bool):
            _err(out, path, f"'curve' size {n}: missing bool "
                 "'decisions_identical_classic' (r18 classic arm)")
        for k in ("host_apply_ms", "host_apply_ms_classic"):
            if not isinstance(e.get(k), (int, float)):
                _err(out, path, f"'curve' size {n}: missing numeric "
                     f"'{k}'")
        for k in ("live_rows", "rows_row_backed"):
            if not isinstance(e.get(k), int):
                _err(out, path, f"'curve' size {n}: missing int '{k}'")
    parity = d.get("parity") if isinstance(d.get("parity"), dict) else {}
    for k in ("decisions_identical_classic_all", "max_res_ts_equal_all"):
        if not isinstance(parity.get(k), bool):
            _err(out, path, f"'parity.{k}' must be a bool (r18)")
    if isinstance(parity.get("decisions_identical_classic_all"), bool) \
            and curve and all(isinstance(e, dict) for e in curve):
        got = all(e.get("decisions_identical_classic") is True
                  for e in curve)
        if parity["decisions_identical_classic_all"] != got:
            _err(out, path, "'parity.decisions_identical_classic_all' "
                 "inconsistent with the per-size verdicts")
    ceiling = d.get("ceiling")
    if not isinstance(ceiling, dict):
        _err(out, path, "r18 artifacts must carry a 'ceiling' block")
        ceiling = {}
    for k in ("cqs", "row_budget", "live_rows", "rows_packed",
              "rows_row_backed"):
        if not isinstance(ceiling.get(k), int):
            _err(out, path, f"'ceiling.{k}' must be an int")
    for k in ("packed_under_budget", "row_backed_over_budget"):
        if not isinstance(ceiling.get(k), bool):
            _err(out, path, f"'ceiling.{k}' must be a bool")
    if isinstance(ceiling.get("rows_packed"), int) \
            and isinstance(ceiling.get("row_budget"), int) \
            and isinstance(ceiling.get("packed_under_budget"), bool) \
            and ceiling["packed_under_budget"] != (
                ceiling["rows_packed"] < ceiling["row_budget"]):
        _err(out, path, "'ceiling.packed_under_budget' inconsistent "
             "with rows_packed vs row_budget")
    rnd = ceiling.get("round")
    if not isinstance(rnd, dict) \
            or not isinstance(rnd.get("wall_s"), (int, float)):
        _err(out, path, "'ceiling.round' must carry numeric 'wall_s' "
             "(the honest per-round wall at the ceiling size)")
    agg = d.get("aggregate")
    if not isinstance(agg, dict):
        _err(out, path, "r18 artifacts must carry an 'aggregate' block")
        agg = {}
    if agg.get("max_res_ts_equal_all") is not True:
        _err(out, path, "'aggregate.max_res_ts_equal_all' must be "
             "true: compression must not move the clock anchor")
    pts = agg.get("points")
    if not isinstance(pts, list) or not pts:
        _err(out, path, "'aggregate.points' must be a non-empty list")
    else:
        for p in pts:
            if not isinstance(p, dict):
                _err(out, path, "'aggregate.points' entries must be "
                     "objects")
                continue
            for k in ("cqs", "live_rows", "rows_packed",
                      "rows_row_backed"):
                if not isinstance(p.get(k), int):
                    _err(out, path, f"'aggregate.points[].{k}' must "
                         "be an int")
            if isinstance(p.get("rows_packed"), int) \
                    and isinstance(p.get("rows_row_backed"), int) \
                    and p["rows_packed"] > p["rows_row_backed"]:
                _err(out, path, "'aggregate.points[]': rows_packed "
                     "must not exceed rows_row_backed")
    heap = d.get("heap")
    if not isinstance(heap, dict):
        _err(out, path, "r18 artifacts must carry a 'heap' block")
        heap = {}
    micro = heap.get("microbench")
    if not isinstance(micro, dict):
        _err(out, path, "'heap.microbench' must be an object")
        micro = {}
    if micro.get("order_parity") is not True:
        _err(out, path, "'heap.microbench.order_parity' must be true: "
             "lazy repair must pop the identical sequence")
    mpts = micro.get("points")
    if not isinstance(mpts, list) or not mpts:
        _err(out, path, "'heap.microbench.points' must be a non-empty "
             "list")
    else:
        for p in mpts:
            for k in ("eager_ms_per_cycle", "lazy_ms_per_cycle",
                      "speedup"):
                if not isinstance(p, dict) \
                        or not isinstance(p.get(k), (int, float)):
                    _err(out, path, "'heap.microbench.points[]' must "
                         f"carry numeric '{k}'")
                    break
    dha = heap.get("driver_host_apply")
    if not isinstance(dha, dict):
        _err(out, path, "'heap.driver_host_apply' must be an object")
    else:
        for k in ("optimized_ms_per_cycle", "classic_ms_per_cycle",
                  "speedup"):
            if not isinstance(dha.get(k), (int, float)):
                _err(out, path, "'heap.driver_host_apply' must carry "
                     f"numeric '{k}'")
    ws = d.get("wal_shard")
    if not isinstance(ws, dict):
        _err(out, path, "r18 artifacts must carry a 'wal_shard' block")
        ws = {}
    if not isinstance(ws.get("shards"), int) or ws.get("shards", 0) < 2:
        _err(out, path, "'wal_shard.shards' must be an int >= 2")
    if ws.get("replay_parity") is not True:
        _err(out, path, "'wal_shard.replay_parity' must be true: the "
             "seq-merged sharded replay must equal the single-file "
             "replay")
    for k in ("single_ms", "sharded_ms"):
        if not isinstance(ws.get(k), (int, float)):
            _err(out, path, f"'wal_shard.{k}' must be numeric")
    res = d.get("residues")
    if not isinstance(res, dict):
        _err(out, path, "r18 artifacts must carry a 'residues' block "
             "(the machine-readable r13-residue ledger)")
        res = {}
    entries = res.get("entries")
    if not isinstance(entries, list) or len(entries) < 3:
        _err(out, path, "'residues.entries' needs >= 3 entries (row "
             "cap, host apply, WAL group commit)")
    else:
        for e in entries:
            if not isinstance(e, dict):
                _err(out, path, "'residues.entries' must be objects")
                continue
            for k in ("id", "residue", "status", "mechanism"):
                if not isinstance(e.get(k), str) or not e[k]:
                    _err(out, path, "'residues.entries[]' must carry "
                         f"non-empty str '{k}'")
            if not isinstance(e.get("evidence"), dict):
                _err(out, path, "'residues.entries[]' must carry an "
                     "'evidence' object of measured values")
    walls = res.get("walls")
    if not isinstance(walls, list) or not walls:
        _err(out, path, "'residues.walls' must be a non-empty list of "
             "named remaining walls")
    else:
        for w in walls:
            if not isinstance(w, dict) \
                    or not isinstance(w.get("id"), str) \
                    or not isinstance(w.get("wall"), str):
                _err(out, path, "'residues.walls[]' must carry str "
                     "'id' and 'wall'")


def _check_scale_r19(d, path, out):
    """SCALE_r19+ (scripts/scale_soak.py, ISSUE 17): the head-only
    packing ceiling probe (>= 1M active CQs with pending work under the
    2^19 row budget on a full run), the parallel host apply/pack plane
    block with its cores-vs-throughput curve and the single-core
    honesty gate, the collapsed-vs-striped WAL arms, and a residue
    ledger that carries all four r18 residues."""
    quick = bool(d.get("quick"))
    ceiling = d.get("ceiling") if isinstance(d.get("ceiling"), dict) \
        else {}
    active = ceiling.get("active_cqs_pending")
    if not isinstance(active, int) or active < 1:
        _err(out, path, "'ceiling.active_cqs_pending' must be an int "
             ">= 1 (the census of CQs with pending work at the probe)")
    elif not quick and active < 1_000_000:
        _err(out, path, f"'ceiling.active_cqs_pending'={active}: a "
             "full r19 run must probe >= 1,000,000 active CQs")
    for k in ("rows_grid", "rows_budget_row_backed", "preempt_cohorts"):
        if not isinstance(ceiling.get(k), int):
            _err(out, path, f"'ceiling.{k}' must be an int (r19)")
    if isinstance(ceiling.get("rows_packed"), int) \
            and isinstance(ceiling.get("row_budget"), int) \
            and ceiling["rows_packed"] > ceiling["row_budget"]:
        _err(out, path, "'ceiling.rows_packed' (the budget-charged "
             "rows) must fit the row budget")
    hp = d.get("head_pack")
    if not isinstance(hp, dict):
        _err(out, path, "r19 artifacts must carry a 'head_pack' block")
        hp = {}
    for k in ("row_budget", "ceiling_cqs", "active_cqs_pending",
              "budget_rows", "grid_rows", "live_rows"):
        if not isinstance(hp.get(k), int):
            _err(out, path, f"'head_pack.{k}' must be an int")
    if not isinstance(hp.get("flag"), str):
        _err(out, path, "'head_pack.flag' must name the env flag")
    pool = d.get("host_pool")
    if not isinstance(pool, dict):
        _err(out, path, "r19 artifacts must carry a 'host_pool' block")
        pool = {}
    for k in ("cqs", "workers", "cores_available"):
        if not isinstance(pool.get(k), int):
            _err(out, path, f"'host_pool.{k}' must be an int")
    for k in ("apply_pack_ms_serial", "apply_pack_ms_pooled",
              "apply_pack_speedup"):
        if not isinstance(pool.get(k), (int, float)):
            _err(out, path, f"'host_pool.{k}' must be numeric")
    if pool.get("decisions_identical") is not True:
        _err(out, path, "'host_pool.decisions_identical' must be "
             "true: the pooled plane may never change a decision")
    curve = pool.get("cores_curve")
    if not isinstance(curve, list) or not curve:
        _err(out, path, "'host_pool.cores_curve' must be a non-empty "
             "list (pooled WAL-commit plane, per worker count)")
    else:
        for p in curve:
            if not isinstance(p, dict) \
                    or not isinstance(p.get("workers"), int) \
                    or not isinstance(p.get("ops_per_s"), (int, float)):
                _err(out, path, "'host_pool.cores_curve[]' must carry "
                     "int 'workers' and numeric 'ops_per_s'")
            elif p.get("seq_order_ok") is not True:
                _err(out, path, "'host_pool.cores_curve[]': pooled "
                     "commits must preserve total seq order")
    # honesty gate: >= 2x apply+pack overlap is only demandable when
    # the box has the cores; a 1-core host records the measured number
    # and the 'cores_available' evidence instead of a fabricated win
    if isinstance(pool.get("apply_pack_speedup"), (int, float)) \
            and isinstance(pool.get("cores_available"), int) \
            and isinstance(pool.get("workers"), int) \
            and pool["apply_pack_speedup"] < 2.0 \
            and pool["cores_available"] >= pool["workers"] \
            and pool["workers"] >= 4:
        _err(out, path, f"'host_pool.apply_pack_speedup'="
             f"{pool['apply_pack_speedup']}: >= 2x required at >= 4 "
             "workers when the box has that many cores")
    ws = d.get("wal_shard") if isinstance(d.get("wal_shard"), dict) \
        else {}
    for k in ("striped_ms",):
        if not isinstance(ws.get(k), (int, float)):
            _err(out, path, f"'wal_shard.{k}' must be numeric (r19 "
                 "striping-engaged arm)")
    if ws.get("collapsed_segments") != 1:
        _err(out, path, "'wal_shard.collapsed_segments' must be 1: a "
             "single appender must auto-collapse to one hot segment")
    if not isinstance(ws.get("striped_segments"), int) \
            or ws.get("striped_segments", 0) < 2:
        _err(out, path, "'wal_shard.striped_segments' must be >= 2: "
             "registered appenders must engage striping")
    # the e2e bulk-apply A/B is single-flag (stream vs the same arm
    # with KUEUE_TPU_CYCLE_BULK_APPLY=0) so the measured speedup is
    # the bulk-apply win alone, not confounded with the aggregate
    # fold tax the classic arm also drops
    heap = d.get("heap") if isinstance(d.get("heap"), dict) else {}
    dha = heap.get("driver_host_apply") \
        if isinstance(heap.get("driver_host_apply"), dict) else {}
    for k in ("bulk_off_ms_per_cycle", "speedup_vs_classic"):
        if not isinstance(dha.get(k), (int, float)):
            _err(out, path, f"'heap.driver_host_apply.{k}' must be "
                 "numeric (r19 single-flag bulk-apply A/B)")
    # The single-flag A/B measures ~1.0x by design, not by accident:
    # r13's incremental settles and the batched finish API already
    # removed the per-call redundancy bulk apply would dedupe, and the
    # e2e apply wall is per-admission-dominated (profiled: ~135us per
    # admission across prepare/assume/slot-assignment vs ~66us per
    # deduped requeue storm).  The gate is therefore "bulk apply never
    # costs" — a materially regressed speedup means the dedupe itself
    # became overhead; the measured ~1.0x is ledgered as a residues
    # wall, not asserted away.
    if not quick and isinstance(dha.get("speedup"), (int, float)) \
            and dha["speedup"] < 0.8:
        _err(out, path, f"'heap.driver_host_apply.speedup'="
             f"{dha['speedup']}: the e2e bulk-apply A/B regressed "
             "below 0.8x — cycle dedupe must never cost more than it "
             "saves in the apply-dominated regime")
    par = d.get("parity") if isinstance(d.get("parity"), dict) else {}
    if par.get("decisions_identical_nobulk_all") is not True:
        _err(out, path, "'parity.decisions_identical_nobulk_all' must "
             "be true: bulk apply may never change a decision")
    res = d.get("residues") if isinstance(d.get("residues"), dict) \
        else {}
    entries = res.get("entries")
    if isinstance(entries, list) and len(entries) < 4:
        _err(out, path, "r19 'residues.entries' needs >= 4 entries "
             "(row cap, host apply, WAL single-appender, lazy heap)")


#: Hot-path phases the OBS artifact's span roster must cover (a subset
#: of obs/trace.py HOT_PATH_PHASES).
_OBS_HOST_PHASES = ("cycle", "cycle.snapshot", "cycle.nominate",
                    "cycle.admit", "wal.append", "wal.commit")


def _check_obs_block(obs, path, out, where="obs"):
    """The ``obs`` block every r16+ soak artifact carries: event-stream
    counts, flight-recorder totals, and the tracing flag."""
    if not isinstance(obs, dict):
        _err(out, path, f"'{where}' must be an object")
        return
    ev = obs.get("events")
    if not isinstance(ev, dict) or not isinstance(ev.get("counts"), dict) \
            or not isinstance(ev.get("total"), int) \
            or not isinstance(ev.get("dropped"), int):
        _err(out, path, f"'{where}.events' needs counts/total/dropped")
    elif sum(ev["counts"].values()) != ev["total"]:
        _err(out, path, f"'{where}.events': counts sum "
             f"{sum(ev['counts'].values())} != total {ev['total']}")
    fl = obs.get("flight")
    if not isinstance(fl, dict) \
            or not isinstance(fl.get("recorded_total"), int) \
            or not isinstance(fl.get("buffered"), int):
        _err(out, path, f"'{where}.flight' needs recorded_total/buffered")
    elif fl["buffered"] > fl["recorded_total"]:
        _err(out, path, f"'{where}.flight': buffered exceeds "
             "recorded_total")
    if not isinstance(obs.get("tracing"), bool):
        _err(out, path, f"'{where}' missing bool 'tracing'")


def _check_obs(d, path, out):
    """OBS_* telemetry artifacts (scripts/obs_soak.py): a traced and an
    interleaved untraced arm over the same scenario, bit-identical
    decision digests, <= 5% traced p50 overhead, a span roster covering
    every host hot-path phase, and working dump surfaces."""
    control = d.get("control")
    if not isinstance(control, dict) \
            or control.get("interleaved") is not True:
        _err(out, path, "'control' must be an object with "
             "interleaved=true (same-box drift-fair untraced arm)")
    if d.get("decisions_identical") is not True:
        _err(out, path, "'decisions_identical' must be true: tracing "
             "may not change a single decision")
    ov = d.get("overhead")
    if not isinstance(ov, dict) \
            or not isinstance(ov.get("traced_p50_ms"), (int, float)) \
            or not isinstance(ov.get("untraced_p50_ms"), (int, float)) \
            or not isinstance(ov.get("ratio"), (int, float)):
        _err(out, path, "'overhead' needs traced_p50_ms / "
             "untraced_p50_ms / ratio")
    else:
        if ov["untraced_p50_ms"] > 0 and abs(
                ov["ratio"] - ov["traced_p50_ms"] / ov["untraced_p50_ms"]
        ) > 1e-6:
            _err(out, path, "'overhead.ratio' does not equal "
                 "traced_p50_ms / untraced_p50_ms")
        if ov["ratio"] > 1.05:
            _err(out, path, f"'overhead.ratio'={ov['ratio']:.4f} breaks "
                 "the <=5% tracing-overhead guarantee")
    spans = d.get("spans")
    if not isinstance(spans, dict):
        _err(out, path, "missing 'spans' roster object")
    else:
        missing = [p for p in _OBS_HOST_PHASES if p not in spans]
        if missing:
            _err(out, path, f"span roster missing hot-path phases "
                 f"{missing}")
        for phase, row in spans.items():
            if not isinstance(row, dict) \
                    or not isinstance(row.get("count"), int) \
                    or not isinstance(row.get("p50_ms"), (int, float)) \
                    or not isinstance(row.get("p99_ms"), (int, float)):
                _err(out, path, f"span roster row '{phase}' needs "
                     "count/p50_ms/p99_ms")
    dumps = d.get("dumps")
    if not isinstance(dumps, dict) \
            or dumps.get("flightrecorder_ok") is not True \
            or dumps.get("sigusr2_ok") is not True \
            or dumps.get("chrome_trace_events", 0) <= 0:
        _err(out, path, "'dumps' must prove flightrecorder_ok, "
             "sigusr2_ok, and a non-empty chrome trace")
    _check_obs_block(d.get("obs"), path, out)
    if not isinstance(d.get("elapsed_s"), (int, float)):
        _err(out, path, "missing numeric 'elapsed_s'")



def _check_traffic(d, path, out):
    """TRAFFIC_* open-loop artifacts (scripts/traffic_soak.py): the
    arrival-process parameters, the SLO, per-arm sustainable-rate
    results with per-rate latency curves (histograms included), the
    interleaved same-box control arm, the replay verdict, and the
    incremental-snapshot host-cost counters."""
    slo = d.get("slo")
    if not isinstance(slo, dict) \
            or not isinstance(slo.get("p99_latency_s"), (int, float)):
        _err(out, path, "'slo' must carry numeric 'p99_latency_s'")
    arrival = d.get("arrival")
    if not isinstance(arrival, dict):
        _err(out, path, "'arrival' must be an object")
    else:
        if not isinstance(arrival.get("process"), str):
            _err(out, path, "'arrival.process' must be a string")
        if not isinstance(arrival.get("seed"), int):
            _err(out, path, "'arrival.seed' must be an int")
    arms = d.get("arms")
    if not isinstance(arms, dict) or not arms:
        _err(out, path, "'arms' must be a non-empty object")
    else:
        for name, a in arms.items():
            if not isinstance(a, dict):
                _err(out, path, f"arm '{name}' must be an object")
                continue
            if not isinstance(a.get("sustainable_rate_per_s"),
                              (int, float)):
                _err(out, path, f"arm '{name}' missing numeric "
                     "'sustainable_rate_per_s'")
            curve = a.get("curve")
            if not isinstance(curve, list) or len(curve) < 2:
                _err(out, path, f"arm '{name}' needs a 'curve' list "
                     "with >= 2 rates")
                continue
            for e in curve:
                if not isinstance(e, dict):
                    _err(out, path, f"arm '{name}' curve entries must "
                         "be objects")
                    break
                for k in ("rate_per_s", "p50_latency_s",
                          "p99_latency_s", "admissions_per_s"):
                    if not isinstance(e.get(k), (int, float)):
                        _err(out, path, f"arm '{name}' curve entry "
                             f"missing numeric '{k}'")
                if not isinstance(e.get("latency_hist"), list):
                    _err(out, path, f"arm '{name}' curve entry missing "
                         "'latency_hist' list")
    control = d.get("control")
    if not isinstance(control, dict) \
            or control.get("interleaved") is not True:
        _err(out, path, "'control' must be an object with "
             "interleaved=true (same-box environment-drift arm)")
    if not isinstance(d.get("replay_identical"), bool):
        _err(out, path, "missing bool 'replay_identical'")
    if not isinstance(d.get("snapshot_counters"), dict):
        _err(out, path, "missing 'snapshot_counters' object")


def _check_fed(d, path, out):
    """FED_* federation-soak artifacts (scripts/federation_soak.py):
    a real federation (>= 4 worker clusters), every fault scenario
    carrying a parity verdict against its fault-free control, zero
    double-admissions anywhere, and strict scenarios proving
    bit-identical post-recovery state via matching digests.  The
    generic scenario-table consistency (all_stable vs the per-scenario
    verdicts) is _check_chaos's job — the 'scenarios' key routes every
    FED artifact through it as well."""
    workers = d.get("workers")
    if not isinstance(workers, int) or workers < 4:
        _err(out, path, f"'workers'={workers}: the federation soak "
             "needs >= 4 worker clusters")
    scenarios = d.get("scenarios")
    if not isinstance(scenarios, dict) or len(scenarios) < 4:
        _err(out, path, "needs >= 4 fault scenarios")
        scenarios = {}
    dbl_total = 0
    for name, s in scenarios.items():
        if not isinstance(s, dict):
            continue
        parity = s.get("parity")
        if parity not in ("strict", "outcome"):
            _err(out, path, f"scenario '{name}': 'parity' must be "
                 f"'strict' or 'outcome' (got {parity!r})")
        dbl = s.get("double_admissions")
        if not isinstance(dbl, int):
            _err(out, path, f"scenario '{name}' missing int "
                 "'double_admissions'")
        else:
            dbl_total += dbl
            if dbl != 0:
                _err(out, path, f"scenario '{name}': "
                     f"{dbl} double-admissions")
        digest = s.get("state_digest")
        if not isinstance(digest, dict) \
                or not isinstance(digest.get("control"), str) \
                or not isinstance(digest.get("faulted"), str):
            _err(out, path, f"scenario '{name}' missing "
                 "'state_digest' {control, faulted}")
        elif (parity == "strict" and s.get("decisions_stable")
                and digest["control"] != digest["faulted"]):
            _err(out, path, f"scenario '{name}': claims strict parity "
                 "but the control/faulted digests differ")
    if d.get("double_admissions_total") != dbl_total:
        _err(out, path, "'double_admissions_total'="
             f"{d.get('double_admissions_total')} but scenarios sum "
             f"to {dbl_total}")
    if not isinstance(d.get("elapsed_s"), (int, float)):
        _err(out, path, "missing numeric 'elapsed_s'")


def _check_serve(d, path, out):
    """SERVE_* serving-soak artifacts (scripts/serve_soak.py): a
    wall-clock soak holding the p99 admission-latency SLO across a
    diurnal swing with the burst window K adapted online, kill/restart
    arms converging bit-identically to an unkilled control with zero
    accepted submissions lost and zero admissions duplicated, a clean
    SIGTERM drain with the WAL flushed, and decision parity between the
    service path and the batch open-loop runner."""
    wall = d.get("wall")
    if not isinstance(wall, dict):
        _err(out, path, "missing 'wall' block")
        wall = {}
    if wall.get("wall_clock") is not True:
        _err(out, path, "'wall.wall_clock' must be true (the serving "
             "soak is a real wall-clock run)")
    for k in ("duration_s", "admissions_per_s"):
        if not isinstance(wall.get(k), (int, float)):
            _err(out, path, f"missing numeric 'wall.{k}'")
    slo = wall.get("slo")
    if not isinstance(slo, dict):
        _err(out, path, "missing 'wall.slo' block")
        slo = {}
    if not isinstance(slo.get("p99_target_s"), (int, float)):
        _err(out, path, "missing numeric 'wall.slo.p99_target_s'")
    if slo.get("held") is not True:
        _err(out, path, "'wall.slo.held' must be true: the service "
             "must hold the p99 SLO across the load swing")
    windows = slo.get("windows")
    if not isinstance(windows, list) or len(windows) < 2:
        _err(out, path, "'wall.slo.windows' needs >= 2 windows "
             "(the SLO must hold across a swing, not one average)")
    else:
        for i, w in enumerate(windows):
            if not isinstance(w, dict) \
                    or not isinstance(w.get("p99_s"), (int, float)):
                _err(out, path, f"window {i} missing numeric 'p99_s'")
    if slo.get("k_adapted") is not True:
        _err(out, path, "'wall.slo.k_adapted' must be true: the burst "
             "window K must actually move with the load swing")
    kill = d.get("kill_restart")
    if not isinstance(kill, dict):
        _err(out, path, "missing 'kill_restart' block")
        kill = {}
    if kill.get("lost_accepted_submissions") != 0:
        _err(out, path, "'kill_restart.lost_accepted_submissions'="
             f"{kill.get('lost_accepted_submissions')}: restart must "
             "lose zero accepted submissions")
    if kill.get("duplicated_admissions") != 0:
        _err(out, path, "'kill_restart.duplicated_admissions'="
             f"{kill.get('duplicated_admissions')}: restart must "
             "duplicate zero admissions")
    if kill.get("decisions_identical") is not True:
        _err(out, path, "'kill_restart.decisions_identical' must be "
             "true against the unkilled control")
    if kill.get("digests_match") is not True:
        _err(out, path, "'kill_restart.digests_match' must be true "
             "against the unkilled control")
    scen = kill.get("scenarios")
    if not isinstance(scen, dict) or len(scen) < 2:
        _err(out, path, "'kill_restart.scenarios' needs >= 2 kill "
             "sites (cycle boundary and ingest path)")
    drain = d.get("drain")
    if not isinstance(drain, dict):
        _err(out, path, "missing 'drain' block")
        drain = {}
    if drain.get("clean") is not True:
        _err(out, path, "'drain.clean' must be true: SIGTERM must "
             "drain and exit clean")
    if not isinstance(drain.get("wal_flushed"), bool):
        _err(out, path, "missing bool 'drain.wal_flushed'")
    elif not drain["wal_flushed"]:
        _err(out, path, "'drain.wal_flushed' must be true")
    parity = d.get("parity")
    if not isinstance(parity, dict):
        _err(out, path, "missing 'parity' block")
        parity = {}
    if parity.get("decisions_identical") is not True:
        _err(out, path, "'parity.decisions_identical' must be true: "
             "service-path decisions must be bit-identical to the "
             "batch open-loop runner")
    if not isinstance(d.get("elapsed_s"), (int, float)):
        _err(out, path, "missing numeric 'elapsed_s'")


def _check_dist(d, path, out):
    """DIST_* distributed-soak artifacts (scripts/dist_soak.py): a
    wall-clock saturation search across >= 2 submitter and >= 2 shard
    processes, four process-kill arms (submitter, front-end shard,
    service mid-cycle, federation worker) each recovering with zero
    lost and zero duplicated admissions and decisions bit-identical
    to a single-process control, plus socket-fault classification."""
    sat = d.get("saturation")
    if not isinstance(sat, dict):
        _err(out, path, "missing 'saturation' block")
        sat = {}
    if sat.get("wall_clock") is not True:
        _err(out, path, "'saturation.wall_clock' must be true (the "
             "ceiling is a measured wall-clock rate)")
    ceiling = sat.get("ceiling_admissions_per_s")
    if not isinstance(ceiling, (int, float)) or ceiling <= 0:
        _err(out, path, "missing positive numeric "
             "'saturation.ceiling_admissions_per_s'")
    for k in ("submitter_procs", "shard_procs"):
        v = sat.get(k)
        if not isinstance(v, int) or v < 2:
            _err(out, path, f"'saturation.{k}'={v}: the distributed "
                 "soak needs >= 2 real processes per role")
    if not isinstance(sat.get("rounds"), list) or not sat["rounds"]:
        _err(out, path, "'saturation.rounds' must be a non-empty list "
             "(the search must show its measurements)")
    kills = d.get("kills")
    if not isinstance(kills, dict):
        _err(out, path, "missing 'kills' block")
        kills = {}
    for arm in ("submitter", "front_end_shard", "service_mid_cycle",
                "federation_worker"):
        k = kills.get(arm)
        if not isinstance(k, dict):
            _err(out, path, f"missing 'kills.{arm}' arm")
            continue
        if k.get("parity") is not True:
            _err(out, path, f"'kills.{arm}.parity' must be true "
                 "against the single-process control")
        if k.get("decisions_identical") is not True:
            _err(out, path, f"'kills.{arm}.decisions_identical' must "
                 "be true: recovery must be bit-identical")
        if k.get("lost") != 0:
            _err(out, path, f"'kills.{arm}.lost'={k.get('lost')}: "
                 "a killed process must lose zero admissions")
        if k.get("duplicated") != 0:
            _err(out, path, f"'kills.{arm}.duplicated'="
                 f"{k.get('duplicated')}: a killed process must "
                 "duplicate zero admissions")
    sock = d.get("socket_faults")
    if not isinstance(sock, dict):
        _err(out, path, "missing 'socket_faults' block")
    elif sock.get("ok") is not True:
        _err(out, path, "'socket_faults.ok' must be true: the client "
             "must classify and survive every wire fault")
    dist = d.get("dist")
    if not isinstance(dist, dict):
        _err(out, path, "missing 'dist' block (supervisor report)")
    elif not dist.get("kill_log"):
        _err(out, path, "'dist.kill_log' is empty: the kill arms must "
             "record real SIGKILLs")
    if not isinstance(d.get("elapsed_s"), (int, float)):
        _err(out, path, "missing numeric 'elapsed_s'")


def validate_tail(d: dict, name: str) -> list[str]:
    """``validate_artifacts.validate`` of a file ``name`` holding ``d``,
    for the CHAOS_ / OBS_ / SCALE_ / TRAFFIC_ / FED_ / SERVE_ / DIST_
    kinds (any other name, ``ROOFLINE_`` among them, gets the common
    checks only, as in ``validate``): the
    common checks, each kind's (by name or by shape, as ``validate``
    dispatches), the obs block of a TRAFFIC_ / FED_ r16+ record, and the
    strict prefixes' metric and value."""
    out: list[str] = []
    path = name
    if not _check_common(d, path, out):
        return out
    base = os.path.basename(path).upper()
    if base.startswith("CHAOS_") or "scenarios" in d:
        _check_chaos(d, path, out)
    if base.startswith("TRAFFIC_") or "arms" in d:
        _check_traffic(d, path, out)
    if base.startswith("SCALE_") or ("soak" in d and "parity" in d):
        _check_scale(d, path, out)
    if base.startswith("FED_") or "double_admissions_total" in d:
        _check_fed(d, path, out)
    if base.startswith("OBS_") or "overhead" in d:
        _check_obs(d, path, out)
    if base.startswith("SERVE_") or ("kill_restart" in d and "wall" in d):
        _check_serve(d, path, out)
    if base.startswith("DIST_") or ("kills" in d and "saturation" in d):
        _check_dist(d, path, out)
    rnd = re.match(r"(?:NORTHSTAR|TRAFFIC|FED)_R(\d+)", base)
    if rnd and int(rnd.group(1)) >= 16:
        if "obs" not in d:
            _err(out, path, f"{base.split('_')[0]}_r16+ artifacts must "
                 "carry an 'obs' block")
        else:
            _check_obs_block(d["obs"], path, out)
    if base.startswith(("CHAOS_", "TRAFFIC_", "SCALE_", "FED_", "OBS_",
                        "SERVE_", "DIST_")):
        _check_metric_value(d, path, out)
    return out
