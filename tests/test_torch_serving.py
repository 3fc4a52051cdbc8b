"""The serving front of the port (``kueue_tpu_torch.serving`` and the
serving endpoints of ``kueue_tpu_torch.visibility``) against the JAX
package's: every case of tests/test_serving.py runs on both packages'
Drivers (the JAX one on its host solver, as the reference test builds
it; the port's ``Driver(device="cpu")``), with the reference test's
assertions on each and its per-cycle decisions, state digests
(``remote.state_digest`` and the reference test's own), counters and
endpoint answers equal between the two.  Then chip_smoke.py phase 21's
arms (``scenarios.serve_loop`` / ``serve_open_loop`` /
``serve_killable``) small on both packages, and a check that only the
service thread runs the admit scans while HTTP handler threads submit.
Tolerance 0."""

from __future__ import annotations

import hashlib
import importlib
import json
import threading
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import pytest

from kueue_tpu_torch import scenarios

PACKAGES = ("kueue_tpu", "kueue_tpu_torch")


def package(root):
    """Package ``root``'s modules that the cases use, and a Driver
    factory (the port's on the CPU)."""
    mods = {name.rsplit(".", 1)[-1]: importlib.import_module(f"{root}.{name}")
            for name in ("api.types", "chaos.injector", "controller.driver",
                         "metrics", "serving", "traffic", "utils.journal",
                         "visibility", "remote", "features",
                         "federation.sim")}
    m = SimpleNamespace(**mods, root=root, chaos=mods["injector"],
                        fed=mods["sim"])
    if root == "kueue_tpu_torch":
        m.driver = lambda clock: mods["driver"].Driver(clock=clock,
                                                       device="cpu")
    else:
        m.driver = lambda clock: mods["driver"].Driver(
            clock=clock, use_device_solver=False)
    return m


@pytest.fixture(autouse=True)
def _chaos_off():
    """Chaos must never leak into the rest of the suite."""
    for root in PACKAGES:
        importlib.import_module(f"{root}.chaos.injector").clear()
    yield
    for root in PACKAGES:
        importlib.import_module(f"{root}.chaos.injector").clear()


class VirtualClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def build(m, n_cqs=2, clock=None):
    t = m.types
    clock = clock if clock is not None else VirtualClock()
    d = m.driver(clock)
    d.apply_resource_flavor(t.ResourceFlavor(name="default"))
    for q in range(n_cqs):
        d.apply_cluster_queue(t.ClusterQueue(
            name=f"cq-{q}", cohort="co",
            queueing_strategy=t.QueueingStrategy.BEST_EFFORT_FIFO,
            preemption=t.PreemptionPolicy(),
            resource_groups=[t.ResourceGroup(
                covered_resources=["cpu"],
                flavors=[t.FlavorQuotas(name="default", resources={
                    "cpu": t.ResourceQuota(nominal=4000)})])]))
        d.apply_local_queue(t.LocalQueue(name=f"lq-{q}",
                                         cluster_queue=f"cq-{q}"))
    return d, clock


def mk_service(m, d, clock, **over):
    kw = dict(dt_s=1.0, k_max=1, journal_path="", high_water=1 << 20,
              epoch_t=clock.t)
    kw.update(over)
    return m.serving.AdmissionService(d, config=m.serving.ServiceConfig(**kw))


def state_digest(d) -> str:
    rows = []
    for key, w in sorted(d.workloads.items()):
        rows.append((key, w.is_finished, w.has_quota_reservation,
                     None if w.admission is None
                     else w.admission.cluster_queue,
                     tuple(sorted((c.type, c.status.value,
                                   c.last_transition_time)
                                  for c in w.conditions.values()))))
    return hashlib.sha256(repr(rows).encode()).hexdigest()[:16]


def digests(m, d):
    return state_digest(d), m.remote.state_digest(d)


# -- the cases of tests/test_serving.py, each → what both packages must
# -- agree on ---------------------------------------------------------------

def case_submit_step_admits(m, tmp):
    d, clock = build(m)
    svc = mk_service(m, d, clock)
    for i in range(3):
        res = svc.submit(name=f"w{i}", queue_name="lq-0",
                         requests={"cpu": 1500})
        assert res.status == "accepted"
        assert res.seq == i + 1
    out = svc.step()
    assert out["decisions"] == [["default/w0"]]
    out2 = svc.step()
    assert svc.admitted_total == 2
    assert svc.stats()["ingest_depth"] == 0
    assert svc.journal.stats["ing_applies"] == 1
    pos = [svc.queue_position(k)["status"]
           for k in ("default/w0", "default/w2", "nope")]
    assert pos == ["admitted", "queued", "unknown"]
    return out["decisions"], out2["decisions"], pos, digests(m, d)


def case_runtime_finish_frees_quota(m, tmp):
    d, clock = build(m, n_cqs=1)
    svc = mk_service(m, d, clock)
    for i in range(4):
        svc.submit(name=f"w{i}", queue_name="lq-0",
                   requests={"cpu": 1500}, runtime_s=1.0)
    decisions = [svc.step()["decisions"] for _ in range(4)]
    assert svc.admitted_total == 4
    assert svc.queue_position("default/w0")["status"] == "finished"
    return decisions, digests(m, d)


def case_idempotent_tokens(m, tmp):
    d, clock = build(m)
    svc = mk_service(m, d, clock)
    first = svc.submit(name="w0", queue_name="lq-0", requests={"cpu": 1500})
    again = svc.submit(name="w0", queue_name="lq-0", requests={"cpu": 1500})
    assert again.duplicate is True
    assert again.seq == first.seq
    assert svc.accepted_total == 1
    assert svc.duplicate_total == 1
    assert svc.journal.seq == 1
    svc.step()
    late = svc.submit(name="w0", queue_name="lq-0", requests={"cpu": 1500})
    assert late.duplicate is True and late.status == "accepted"
    assert svc.ingest.depth() == 0
    return [vars(r) for r in (first, again, late)], digests(m, d)


def case_backpressure_rejects_at_high_water(m, tmp):
    d, clock = build(m)
    svc = mk_service(m, d, clock, high_water=2)
    for i in range(2):
        svc.submit(name=f"w{i}", queue_name="lq-0",
                   requests={"cpu": 1500}, priority=10)
    res = svc.submit(name="w2", queue_name="lq-0",
                     requests={"cpu": 1500}, priority=10)
    assert res.status == "rejected"
    assert res.reason == "backpressure"
    assert res.retry_after_s > 0
    assert svc.rejected_total == 1
    assert svc.ingest.depth() == 2
    return vars(res), svc.stats()["rejected"]


def case_backpressure_sheds_lowest_priority_for_higher(m, tmp):
    d, clock = build(m)
    svc = mk_service(m, d, clock, high_water=2)
    svc.submit(name="lo0", queue_name="lq-0", requests={"cpu": 1500},
               priority=0)
    svc.submit(name="lo1", queue_name="lq-0", requests={"cpu": 1500},
               priority=0)
    res = svc.submit(name="hi", queue_name="lq-0", requests={"cpu": 1500},
                     priority=20)
    assert res.status == "accepted"
    assert svc.shed_total == 1
    assert svc.ingest.depth() == 2
    assert svc.queue_position("default/lo1")["status"] == "shed"
    assert svc.queue_position("default/lo0")["status"] == "pending"
    assert svc.journal.stats["ing_sheds"] == 1
    svc.step()
    admitted = [k for cyc in svc.telemetry[-1]["decisions"] for k in cyc]
    assert "default/hi" in admitted and "default/lo1" not in admitted
    return vars(res), admitted, digests(m, d)


def case_adaptive_burst_window_tracks_backlog(m, tmp):
    d, clock = build(m, n_cqs=1)
    svc = mk_service(m, d, clock, k_max=8, ewma_halflife_s=1.0)
    for i in range(24):
        svc.submit(name=f"b{i}", queue_name="lq-0",
                   requests={"cpu": 1500}, runtime_s=1.0)
    out = svc.step()
    assert out["k"] > 1
    while svc.admitted_total < 24:
        svc.step()
    ks = {s["k"] for s in svc.telemetry}
    assert max(ks) > 1
    for _ in range(8):
        svc.step()
    assert svc.telemetry[-1]["k"] == 1
    return ([(s["k"], s["decisions"]) for s in svc.telemetry],
            digests(m, d))


def _concurrent_submit(svc, n, threads, epoch):
    barrier = threading.Barrier(threads)
    errs = []

    def worker(lane):
        try:
            barrier.wait()
            for i in range(lane, n, threads):
                svc.submit(name=f"c{i}", queue_name=f"lq-{i % 2}",
                           requests={"cpu": 1500}, priority=(i % 3) * 10,
                           creation_time=epoch + i * 0.01)
        except Exception as e:           # pragma: no cover
            errs.append(e)

    ts = [threading.Thread(target=worker, args=(k,))
          for k in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert errs == []


def case_concurrent_ingest_matches_serial_control(m, tmp):
    n, steps = 36, 6
    d1, c1 = build(m)
    ctl = mk_service(m, d1, c1)
    for i in range(n):
        ctl.submit(name=f"c{i}", queue_name=f"lq-{i % 2}",
                   requests={"cpu": 1500}, priority=(i % 3) * 10,
                   creation_time=ctl.epoch + i * 0.01)
    ctl_decisions = [ctl.step()["decisions"] for _ in range(steps)]
    d2, c2 = build(m)
    svc = mk_service(m, d2, c2)
    _concurrent_submit(svc, n, threads=4, epoch=svc.epoch)
    assert svc.accepted_total == n
    decisions = [svc.step()["decisions"] for _ in range(steps)]
    assert decisions == ctl_decisions
    assert state_digest(d2) == state_digest(d1)
    flat = [k for s in decisions for cyc in s for k in cyc]
    assert len(flat) == len(set(flat))
    assert svc.journal.stats["ing_accepts"] == n
    return decisions, digests(m, d2)


def case_submitters_racing_live_drain_lose_nothing(m, tmp):
    d, clock = build(m)
    svc = mk_service(m, d, clock)
    n = 60
    done = threading.Event()

    def stepper():
        while not done.is_set():
            svc.step()

    st = threading.Thread(target=stepper)
    st.start()
    try:
        _concurrent_submit(svc, n, threads=4, epoch=svc.epoch)
    finally:
        done.set()
        st.join()
    svc.step()
    assert svc.accepted_total == n
    assert svc.ingest.depth() == 0
    assert len(d.workloads) == n
    assert svc.journal.stats["ing_accepts"] == n
    # how the race interleaved differs from run to run: the outcome
    # both packages must share is the set applied, each exactly once
    return sorted(d.workloads), svc.accepted_total


def case_ingest_crash_recovers_accepted_submission(m, tmp):
    d, clock = build(m)
    wal = m.journal.CycleWAL(path=str(tmp / "a.wal"))
    d.attach_wal(wal)
    jp = str(tmp / "a.ing")
    cfg = m.serving.ServiceConfig(dt_s=1.0, k_max=1, journal_path=jp,
                                  high_water=1 << 20, epoch_t=clock.t)
    svc = m.serving.AdmissionService(d, config=cfg, wal=wal)
    svc.submit(name="w0", queue_name="lq-0", requests={"cpu": 1500})
    inj = m.chaos.install(m.chaos.ChaosInjector(seed=7))
    inj.arm("svc.ingest", at=1)
    with pytest.raises(m.chaos.InjectedCrash):
        svc.submit(name="w1", queue_name="lq-0", requests={"cpu": 1500})
    m.chaos.clear()
    d2, _ = build(m, clock=clock)
    svc2 = m.serving.recover_service(d2, d.workloads.values(), wal,
                                     config=cfg)
    assert svc2.ingest.depth() == 2
    assert svc2.submit(name="w1", queue_name="lq-0",
                       requests={"cpu": 1500}).duplicate is True
    decisions = [svc2.step()["decisions"], svc2.step()["decisions"]]
    pos = [svc2.queue_position(k)["status"]
           for k in ("default/w0", "default/w1")]
    assert pos == ["admitted", "admitted"]
    return decisions, digests(m, d2)


def case_cycle_crash_recovery_matches_control(m, tmp):
    batches = [[("w1", 0), ("w2", 10)], [("w3", 0)], [("w4", 20)],
               [("w5", 0)], []]

    def run(kill_at, tag):
        d, clock = build(m)
        wal = m.journal.CycleWAL(path=str(tmp / f"{tag}.wal"))
        d.attach_wal(wal)
        cfg = m.serving.ServiceConfig(
            dt_s=1.0, k_max=1, journal_path=str(tmp / f"{tag}.ing"),
            high_water=1 << 20, epoch_t=clock.t)
        svc = m.serving.AdmissionService(d, config=cfg, wal=wal)
        if kill_at:
            m.chaos.install(m.chaos.ChaosInjector(seed=3)).arm(
                "svc.cycle", at=kill_at)
        decisions, s = [], 0
        while s < len(batches):
            try:
                for (name, prio) in batches[s]:
                    svc.submit(name=name, queue_name="lq-0",
                               requests={"cpu": 1500}, priority=prio,
                               runtime_s=2.0)
                decisions.append(svc.step()["decisions"])
                s += 1
            except m.chaos.InjectedCrash:
                m.chaos.clear()
                d2, _ = build(m, clock=clock)
                svc = m.serving.recover_service(d2, d.workloads.values(),
                                                wal, config=cfg)
                d = d2
        return d, decisions

    d_ctl, dec_ctl = run(0, "ctl")
    d_kill, dec_kill = run(3, "kill")
    assert dec_kill == dec_ctl
    assert state_digest(d_kill) == state_digest(d_ctl)
    return dec_kill, digests(m, d_kill)


def case_shutdown_crash_then_recovered_drain(m, tmp):
    d, clock = build(m)
    wal = m.journal.CycleWAL(path=str(tmp / "s.wal"))
    d.attach_wal(wal)
    cfg = m.serving.ServiceConfig(dt_s=1.0, k_max=1,
                                  journal_path=str(tmp / "s.ing"),
                                  high_water=1 << 20, epoch_t=clock.t)
    svc = m.serving.AdmissionService(d, config=cfg, wal=wal)
    svc.submit(name="w0", queue_name="lq-0", requests={"cpu": 1500})
    m.chaos.install(m.chaos.ChaosInjector(seed=5)).arm("svc.shutdown", at=1)
    with pytest.raises(m.chaos.InjectedCrash):
        svc.drain()
    m.chaos.clear()
    assert not svc.stopped
    d2, _ = build(m, clock=clock)
    svc2 = m.serving.recover_service(d2, d.workloads.values(), wal,
                                     config=cfg)
    assert svc2.drain() is True
    assert svc2.stopped and svc2.drained_clean
    assert svc2.queue_position("default/w0")["status"] == "admitted"
    return digests(m, d2)


def case_graceful_drain_stops_accepting(m, tmp):
    d, clock = build(m)
    svc = mk_service(m, d, clock)
    svc.submit(name="w0", queue_name="lq-0", requests={"cpu": 1500})
    svc.request_drain()
    res = svc.submit(name="late", queue_name="lq-0", requests={"cpu": 1500})
    assert res.status == "draining"
    assert svc.drain() is True
    assert svc.drained_clean and svc.stopped
    assert svc.ingest.depth() == 0
    assert "default/late" not in d.workloads
    return vars(res), digests(m, d)


def case_ingest_journal_roundtrip(m, tmp):
    path = str(tmp / "j.ing")
    j = m.journal.IngestJournal(path)
    s1 = j.accept("t1", {"name": "a"})
    s2 = j.accept("t2", {"name": "b"})
    s3 = j.accept("t3", {"name": "c"})
    j.shed(s2, "t2")
    j.mark_applied(s1, cycle=0)
    j.close()
    back = m.journal.IngestJournal.load(path)
    assert back.seq == 3
    assert back.applied_upto == s1
    assert back.shed_seqs == {s2}
    assert [r["seq"] for r in back.unapplied()] == [s3]
    cont = m.journal.IngestJournal.resume(path)
    assert cont.accept("t4", {"name": "d"}) == 4
    cont.close()
    with open(path, encoding="utf-8") as fh:
        return [json.loads(line) for line in fh if line.strip()]


def case_rate_ewma_primes_then_tracks(m, tmp):
    e = m.traffic.RateEWMA(halflife_s=2.0)
    assert e.update(10, 1.0) == 10.0
    rates = [e.update(40, 1.0) for _ in range(20)]
    assert 35.0 < e.rate_per_s <= 40.0
    with pytest.raises(ValueError):
        m.traffic.RateEWMA(halflife_s=0.0)
    return rates


def case_registry_concurrent_hammer(m, tmp):
    reg = m.metrics.Registry()
    threads_n, per = 8, 500
    errs = []
    stop = threading.Event()

    def render_loop():
        try:
            while not stop.is_set():
                reg.render()
        except Exception as e:           # pragma: no cover
            errs.append(e)

    def hammer(lane):
        try:
            for i in range(per):
                reg.inc("kueue_admission_attempts_total", ("success",))
                reg.set_gauge("kueue_svc_ingest_depth", (), float(i))
                reg.add_gauge("kueue_svc_burst_window", (), 1.0)
                reg.observe("kueue_svc_admission_latency_seconds", (),
                            0.001 * (i % 7 + 1))
        except Exception as e:           # pragma: no cover
            errs.append(e)

    rt = threading.Thread(target=render_loop)
    rt.start()
    ts = [threading.Thread(target=hammer, args=(k,))
          for k in range(threads_n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    stop.set()
    rt.join()
    assert errs == []
    total = threads_n * per
    assert reg.counters[("kueue_admission_attempts_total", "success")] \
        == total
    assert reg.gauges[("kueue_svc_burst_window",)] == float(total)
    h = reg.histograms[("kueue_svc_admission_latency_seconds",)]
    assert h.n == total
    return total, h.n


def case_service_metrics_rendered(m, tmp):
    d, clock = build(m)
    svc = mk_service(m, d, clock)
    svc.submit(name="w0", queue_name="lq-0", requests={"cpu": 1500})
    svc.step()
    text = d.metrics.render()
    assert 'kueue_svc_submissions_total{result="accepted"} 1' in text
    assert "kueue_svc_admission_latency_seconds_count" in text
    assert "kueue_svc_burst_window 1" in text
    return sorted(line for line in text.splitlines()
                  if line.startswith("kueue_svc_")
                  and "latency" not in line)


def case_service_env_flags_registered(m, tmp):
    for flag in ("KUEUE_TPU_SVC_HIGH_WATER", "KUEUE_TPU_SVC_SLO_P99_S",
                 "KUEUE_TPU_SVC_DRAIN_TIMEOUT_S",
                 "KUEUE_TPU_SVC_INGEST_JOURNAL", "KUEUE_TPU_SVC_SEED"):
        assert flag in m.features.ENV_FLAGS
    assert m.features.env_int("KUEUE_TPU_SVC_HIGH_WATER") > 0
    cfg = m.serving.ServiceConfig().resolved()
    assert cfg.high_water == m.features.env_int("KUEUE_TPU_SVC_HIGH_WATER")
    assert cfg.slo_p99_s > 0 and cfg.drain_timeout_s > 0
    return vars(cfg)


def _post(url, body):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=5) as resp:
        return resp.status, json.loads(resp.read())


def case_visibility_serving_endpoints(m, tmp):
    d, clock = build(m)
    svc = mk_service(m, d, clock, high_water=2)
    server = m.visibility.VisibilityServer(d, admission=svc)
    port = server.start()
    base = f"http://127.0.0.1:{port}/apis/serving/v1"
    try:
        code, body = _post(f"{base}/submit",
                           {"name": "v0", "queue_name": "lq-0",
                            "requests": {"cpu": 1500}})
        assert code == 200 and body["status"] == "accepted"
        tok = body["token"]
        pos = json.loads(urllib.request.urlopen(
            f"{base}/position?token={tok}", timeout=5).read())
        assert pos["status"] == "pending" and pos["position"] == 0
        pend = json.loads(urllib.request.urlopen(
            f"{base}/pending", timeout=5).read())
        assert pend["ingest_depth"] == 1
        assert pend["items"][0]["token"] == tok
        _post(f"{base}/submit", {"name": "v1", "queue_name": "lq-1",
                                 "requests": {"cpu": 1500}})
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(f"{base}/submit", {"name": "v2", "queue_name": "lq-0",
                                     "requests": {"cpu": 1500}})
        assert ei.value.code == 429
        assert ei.value.headers.get("Retry-After") is not None
        out = svc.step()
        stats = json.loads(urllib.request.urlopen(
            f"{base}/stats", timeout=5).read())
        assert stats["admitted"] == 2
        metrics = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=5).read().decode()
        assert "kueue_svc_submissions_total" in metrics
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"{base}/nope", timeout=5)
    finally:
        server.stop()
    return (body, pos, pend, out["decisions"],
            {k: stats[k] for k in ("accepted", "admitted", "rejected",
                                   "shed", "ingest_depth")},
            digests(m, d))


CASES = {name[len("case_"):]: fn for name, fn in globals().items()
         if name.startswith("case_")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_serving_case_on_both_packages(name, tmp_path):
    """The reference case passes on each package, and what it decided
    (decisions a cycle, digests, counters, endpoint answers) is equal."""
    got = []
    for root in PACKAGES:
        tmp = tmp_path / root
        tmp.mkdir()
        got.append(CASES[name](package(root), tmp))
    assert got[0] == got[1]


# -- chip_smoke.py phase 21's arms, small ------------------------------------

N_CQS = 8
RATE = 2.7          # half of 8 CQs' capacity estimate (5.3/s)
CYCLES = 12


def _events(seed=1109):
    return scenarios.serve_events(
        scenarios.traffic_stream(N_CQS, RATE, seed), CYCLES)


def _port(root):
    m = package(root)
    if root == "kueue_tpu_torch":
        m = scenarios.serving_modules("cpu")
    return m


@pytest.mark.parametrize("root", PACKAGES)
def test_serve_loop_matches_the_open_loop(root):
    """serve_soak.py ``arm_parity``: the service loop with K pinned to 1
    and ``run_open_loop`` on a fresh Driver decide the same cycles and
    reach the same state, on either package."""
    m = _port(root)
    ev = _events()
    svc = scenarios.serve_loop(m, N_CQS, ev, CYCLES)
    ol = scenarios.serve_open_loop(m, N_CQS, ev, CYCLES)
    assert svc["decisions"] == ol["decisions"]
    assert sum(map(len, svc["decisions"])) > 0
    assert (m.remote.state_digest(svc["driver"])
            == m.remote.state_digest(ol["driver"]))


def test_serve_arms_equal_across_packages(tmp_path):
    """Phase 21's arms on the JAX package and on the port: the parity
    arm, the adaptive-K arm fed by 4 submitter threads (no accepted
    submission lost, none admitted twice), and the kill-restart arm at
    ``svc.cycle`` (the middle step) and ``svc.ingest`` against the
    unkilled control — every decision and digest equal."""
    ev = _events()
    got = {}
    for root in PACKAGES:
        m = _port(root)
        par = scenarios.serve_loop(m, N_CQS, ev, CYCLES)
        ad = scenarios.serve_loop(m, N_CQS, ev, CYCLES, k_max=8, threads=4)
        lost, dup = scenarios.lost_and_duplicated(
            ad["accepted"], ad["driver"], ad["decisions"])
        assert len(ad["accepted"]) == len(ev)
        assert (lost, dup) == (0, 0)
        assert max(ad["ks"]) > 1
        td = tmp_path / root
        td.mkdir()
        ctl = scenarios.serve_killable(m, N_CQS, ev, CYCLES, str(td), "ctl")
        kills = {}
        for site, at in (("svc.cycle", CYCLES // 2 + 1),
                         ("svc.ingest", len(ev) // 2)):
            k = scenarios.serve_killable(m, N_CQS, ev, CYCLES, str(td),
                                         site, kill_site=site, kill_at=at)
            assert k["crashed"], site
            assert k["decisions"] == ctl["decisions"], site
            assert (m.remote.state_digest(k["driver"])
                    == m.remote.state_digest(ctl["driver"])), site
            kills[site] = (k["decisions"],
                           m.remote.state_digest(k["driver"]))
        got[root] = (par["decisions"], m.remote.state_digest(par["driver"]),
                     ad["decisions"], ad["ks"],
                     m.remote.state_digest(ad["driver"]), kills)
    assert got["kueue_tpu"] == got["kueue_tpu_torch"]


def test_serve_cpu_prefix_matches_the_full_run():
    """Phase 21 (d) on the CPU: the service arm over its first cycles
    decides exactly the first cycles of the longer run."""
    m = scenarios.serving_modules("cpu")
    ev = _events()
    full = scenarios.serve_loop(m, N_CQS, ev, CYCLES)
    head = scenarios.serve_loop(m, N_CQS, [e for e in ev if e.t <= 5],
                                5)
    assert head["decisions"] == full["decisions"][:5]


def test_only_the_service_thread_runs_the_admit_scans(monkeypatch):
    """The service thread (``AdmissionService.serve``) is the only one
    that touches the Driver: submissions over the VisibilityServer's
    HTTP handler threads and from a submitter thread never reach an
    admit scan (on the CPU the scans run their plain versions, which
    stand for the kernels here; chip_smoke.py phase 21 checks the
    kernels' launching thread on the card)."""
    from kueue_tpu_torch.ops import cycle
    from kueue_tpu_torch.visibility import VisibilityServer
    threads = []
    for name in ("admit_scan_plain", "admit_scan_forests_plain",
                 "admit_scan_preempt_plain"):
        fn = getattr(cycle, name)

        def wrapped(*a, _fn=fn, **kw):
            threads.append(threading.get_ident())
            return _fn(*a, **kw)
        monkeypatch.setattr(cycle, name, wrapped)
    m = scenarios.serving_modules("cpu")
    d = scenarios.serve_driver(m, 4, time.time)
    svc = m.serving.AdmissionService(d, config=m.serving.ServiceConfig(
        dt_s=0.02, k_max=4, journal_path="", high_water=1 << 20))
    server = VisibilityServer(d, admission=svc)
    port = server.start()
    stop = threading.Event()
    loop = threading.Thread(target=svc.serve, args=(stop,))
    loop.start()
    try:
        base = f"http://127.0.0.1:{port}/apis/serving/v1"
        for i in range(4):
            _post(f"{base}/submit", {"name": f"h{i}",
                                     "queue_name": f"lq-{i % 4}",
                                     "requests": {"cpu": 1500}})
        sub = threading.Thread(target=lambda: [
            svc.submit(name=f"t{i}", queue_name=f"lq-{i % 4}",
                       requests={"cpu": 1500}) for i in range(4)])
        sub.start()
        sub.join()
        for _ in range(500):
            if svc.admitted_total >= 8:
                break
            stop.wait(0.01)
    finally:
        stop.set()
        loop.join(timeout=30)
        server.stop()
    assert svc.admitted_total == 8
    assert threads and set(threads) == {loop.ident}
