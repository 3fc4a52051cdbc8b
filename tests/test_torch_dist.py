"""The port's distributed control plane (``kueue_tpu_torch.dist``): the
six cases of tests/test_dist_serving.py with every child process started
through the port's ``child_argv`` (``python -m
kueue_tpu_torch.dist.child --device cpu``), each against its
single-process control on the port, and that control against the JAX
package's fed the same payloads: per-step decisions and state digests
equal, tolerance 0.  Also: no child argv names a module of the JAX
package, a child asked for a card it cannot open dies and the
supervisor reports it, and chip_smoke.py phase 23's two arms
(``scenarios.dist_kill_front_end_shard`` /
``dist_kill_federation_worker``) at dist_soak.py's quick size on the
CPU.  Readiness waits are bounded at ``READY_S``: a child imports torch
before it binds."""

from __future__ import annotations

import json
import os

import pytest
import torch

from kueue_tpu_torch import scenarios
from kueue_tpu_torch.chaos import injector as chaos
from kueue_tpu_torch.dist.serving import (
    ShardClient,
    build_shard_service,
    shard_of,
    step_payloads,
)
from kueue_tpu_torch.dist.supervisor import ProcessSupervisor, child_argv
from kueue_tpu_torch.remote import state_digest

pytestmark = pytest.mark.skipif(
    os.environ.get("KUEUE_TPU_SKIP_PROC_TESTS") == "1",
    reason="process spawning disabled")

READY_S = 120.0


@pytest.fixture(autouse=True)
def _chaos_off():
    from kueue_tpu.chaos import injector as jax_chaos
    chaos.clear()
    jax_chaos.clear()
    yield
    chaos.clear()
    jax_chaos.clear()


N_CQS = 8
N_SHARDS = 2
N_SUB = 2
PER_STEP = 3


def _shard_argv(tmp, shard_id, recover=False, resume_cycle=0,
                port=0, crash_site="", crash_at=0):
    pf = f"{tmp}/shard{shard_id}.port"
    kw = dict(shard_id=shard_id, n_cqs=N_CQS, state_dir=str(tmp),
              port_file=pf, recover=recover, resume_cycle=resume_cycle,
              port=port, device="cpu")
    if crash_site:
        kw.update(crash_site=crash_site, crash_at=crash_at)
    return child_argv("shard", **kw), pf


def _spawn_shard(sup, tmp, shard_id, **kw):
    argv, pf = _shard_argv(tmp, shard_id, **kw)
    mp = sup.spawn(f"shard{shard_id}", "shard", argv, port_file=pf)
    return mp, argv


def _spawn_submitter(sup, tmp, j, ports):
    mp = sup.spawn(
        f"sub{j}", "submitter",
        child_argv("submitter", submitter_id=j, n_submitters=N_SUB,
                   per_step=PER_STEP, n_cqs=N_CQS,
                   shard_ports=",".join(map(str, ports))),
        pipe_stdio=True)
    assert mp.proc.stdout.readline().strip() == "ready"
    return mp


class Controls:
    """The single-process control on the port (``device="cpu"``) and on
    the JAX package, fed the same payloads; ``step`` returns the port's
    decisions after asserting the JAX package's equal."""

    def __init__(self, tmp):
        from kueue_tpu.dist import serving as jax_serving
        os.makedirs(f"{tmp}/ctl", exist_ok=True)
        os.makedirs(f"{tmp}/jax", exist_ok=True)
        self.svcs = [build_shard_service(0, N_CQS, f"{tmp}/ctl",
                                         device="cpu")[0],
                     jax_serving.build_shard_service(0, N_CQS,
                                                     f"{tmp}/jax")[0]]

    def submit(self, step, submitter_id, n_sub=N_SUB):
        for svc in self.svcs:
            for b in step_payloads(step, submitter_id, n_sub, PER_STEP,
                                   N_CQS):
                svc.submit(name=b["name"], queue_name=b["queue_name"],
                           requests=b["requests"], priority=b["priority"],
                           namespace=b["namespace"],
                           runtime_s=b["runtime_s"], count=b["count"],
                           token=b["token"])

    def step(self):
        outs = [svc.step()["decisions"] for svc in self.svcs]
        assert outs[0] == outs[1]
        return sorted(k for dec in outs[0] for k in dec)

    def digests(self):
        got = [state_digest(svc.driver) for svc in self.svcs]
        assert got[0] == got[1]
        return got[0]


def _lockstep(subs, clients, ctl, step):
    for mp in subs:
        mp.proc.stdin.write(f"step {step}\n")
        mp.proc.stdin.flush()
    for mp in subs:
        assert mp.proc.stdout.readline().startswith("done")
    for j in range(N_SUB):
        ctl.submit(step, j)
    got = []
    for c in clients:
        st = c.step(retry_deadline_s=15.0)
        for dec in st["decisions"]:
            got.extend(dec)
    return sorted(got), ctl.step()


def test_shard_kill_restart_parity(tmp_path):
    """SIGKILL one front-end shard at a barrier, recover it from its
    journals on the same port, resync the submitters: decisions equal to
    the control (the port's and the JAX package's), every resubmission
    deduped."""
    tmp = str(tmp_path)
    sup = ProcessSupervisor(seed=11)
    shards = [_spawn_shard(sup, tmp, s)[0] for s in range(N_SHARDS)]
    try:
        for mp in shards:
            sup.wait_ready(mp, timeout=READY_S)
        ports = [mp.port for mp in shards]
        subs = [_spawn_submitter(sup, tmp, j, ports)
                for j in range(N_SUB)]
        ctl = Controls(tmp)
        clients = [ShardClient(p) for p in ports]
        for s in range(2):
            got, want = _lockstep(subs, clients, ctl, s)
            assert got == want
        inj = chaos.ChaosInjector(seed=11)
        inj.arm("dist.kill", at=1, payload="shard0")
        chaos.install(inj)
        assert sup.maybe_kill("shard0")
        assert not shards[0].alive
        argv, _ = _shard_argv(tmp, 0, recover=True, resume_cycle=2,
                              port=ports[0])
        sup.restart("shard0", argv=argv, timeout=READY_S)
        assert shards[0].port == ports[0]
        for mp in subs:
            mp.proc.stdin.write("resync 2\n")
            mp.proc.stdin.flush()
        for mp in subs:
            assert int(mp.proc.stdout.readline().split()[2]) == 2 * PER_STEP
        for s in range(2, 4):
            got, want = _lockstep(subs, clients, ctl, s)
            assert got == want
        for mp in subs:
            mp.proc.stdin.write("stats\n")
            mp.proc.stdin.flush()
            st = json.loads(mp.proc.stdout.readline())
            assert st["accepted"] == 4 * PER_STEP
            assert st["duplicates"] == 2 * PER_STEP
        rep = sup.report()
        assert rep["by_role"]["shard"]["kills"] == 1
        assert rep["by_role"]["shard"]["restarts"] == 1
        assert rep["kill_log"] == ["shard0"]
        ctl.digests()
    finally:
        sup.terminate_all()


def test_service_mid_cycle_crash_recovery(tmp_path):
    """The shard dies mid-request at an armed ``svc.cycle`` crashpoint
    (exit 17); recovery from its journals plus a re-issued step lands on
    the controls' decisions."""
    tmp = str(tmp_path)
    sup = ProcessSupervisor(seed=11)
    mp, _ = _spawn_shard(sup, tmp, 0, crash_site="svc.cycle", crash_at=2)
    try:
        sup.wait_ready(mp, timeout=READY_S)
        port = mp.port
        ctl = Controls(tmp)
        client = ShardClient(port)
        crashes = 0
        for s in range(3):
            for b in step_payloads(s, 0, 1, PER_STEP, N_CQS):
                client.submit(b, retry_deadline_s=5.0)
            ctl.submit(s, 0, n_sub=1)
            try:
                st = client.step()
            except Exception:
                mp.proc.wait(timeout=10)
                assert mp.proc.returncode == 17
                crashes += 1
                argv, _ = _shard_argv(tmp, 0, recover=True,
                                      resume_cycle=s, port=port)
                sup.restart("shard0", argv=argv, timeout=READY_S)
                st = client.step(retry_deadline_s=10.0)
            got = sorted(k for dec in st["decisions"] for k in dec)
            assert got == ctl.step()
        assert crashes == 1
    finally:
        sup.terminate_all()


def test_submitter_kill_restart_dedupe(tmp_path):
    """SIGKILL a submitter mid-run; its respawn replays the schedule from
    zero and every delivered submission dedupes."""
    tmp = str(tmp_path)
    sup = ProcessSupervisor(seed=11)
    shard, _ = _spawn_shard(sup, tmp, 0)
    try:
        sup.wait_ready(shard, timeout=READY_S)
        ports = [shard.port]
        subs = [_spawn_submitter(sup, tmp, j, ports)
                for j in range(N_SUB)]
        ctl = Controls(tmp)
        clients = [ShardClient(ports[0])]
        for s in range(2):
            got, want = _lockstep(subs, clients, ctl, s)
            assert got == want
        assert sup.kill("sub0")
        sub0 = _spawn_submitter(sup, tmp, 0, ports)
        subs[0] = sub0
        sub0.proc.stdin.write("resync 2\n")
        sub0.proc.stdin.flush()
        assert int(sub0.proc.stdout.readline().split()[2]) == 2 * PER_STEP
        for s in range(2, 4):
            got, want = _lockstep(subs, clients, ctl, s)
            assert got == want
        st = clients[0].svc_stats()
        assert st["accepted"] == 4 * PER_STEP * N_SUB
        assert st["duplicate"] == 2 * PER_STEP
    finally:
        sup.terminate_all()


def test_shard_routing_keeps_cohorts_together():
    """Every ClusterQueue of a cohort routes to the same shard, as the
    JAX package routes it."""
    from kueue_tpu.dist.serving import shard_of as jax_shard_of
    for n_shards in (1, 2, 3, 4):
        for q in range(64):
            cohort_shard = shard_of(f"lq-{(q // 4) * 4}", n_shards)
            assert shard_of(f"lq-{q}", n_shards) == cohort_shard
            assert jax_shard_of(f"lq-{q}", n_shards) == cohort_shard
    assert shard_of("lq-abc", 4) == shard_of("lq-abc", 4)


def test_federation_worker_kill_parity(tmp_path):
    """SIGKILL a federation worker process at a barrier; its journal
    rebuild and fresh-watch-epoch resync over the socket keep every
    digest equal to the in-process FederationSim control on the port,
    whose digests equal the JAX package's control."""
    from kueue_tpu.federation.sim import FederationSim as JaxSim
    from kueue_tpu.federation.sim import FedSpec as JaxSpec
    from kueue_tpu.remote import state_digest as jax_digest
    from kueue_tpu_torch.federation.procs import ProcFederation, fed_traffic
    from kueue_tpu_torch.federation.sim import FederationSim, FedSpec
    tmp = str(tmp_path)
    n_cqs, remote_cqs = 6, 4
    sup = ProcessSupervisor(seed=11)

    def worker_argv(name, recover=False, resume_t=None, port=0):
        pf = f"{tmp}/{name}.port"
        return child_argv("worker", name=name, remote_cqs=remote_cqs,
                          state_dir=tmp, port_file=pf, recover=recover,
                          resume_t=resume_t, port=port, device="cpu"), pf

    def spawn_worker(name):
        argv, pf = worker_argv(name)
        return sup.spawn(name, "worker", argv, port_file=pf)

    workers = {n: spawn_worker(n) for n in ("w0", "w1")}
    try:
        for mp in workers.values():
            sup.wait_ready(mp, timeout=READY_S)
        urls = {n: f"http://127.0.0.1:{mp.port}"
                for n, mp in workers.items()}
        traffic = fed_traffic(steps=4, per_step=2, n_cqs=n_cqs)
        fed = ProcFederation(urls, n_cqs=n_cqs, remote_cqs=remote_cqs,
                             device="cpu")
        fed.load_traffic(traffic)
        kw = dict(n_workers=2, n_cqs=n_cqs, remote_cqs=remote_cqs,
                  manager_quota_m=8000, worker_quota_m=4000,
                  runtime_steps=2, worker_lost_timeout=3.0,
                  reconnect_budget=0)
        ctl = FederationSim(FedSpec(device="cpu", **kw),
                            wal_dir=f"{tmp}/ctl")
        ctl.load_traffic(dict(traffic))
        jctl = JaxSim(JaxSpec(**kw), wal_dir=f"{tmp}/jax")
        jctl.load_traffic(dict(traffic))
        for _ in range(3):
            fed.step()
            ctl.step()
            jctl.step()
        port0 = workers["w0"].port
        inj = chaos.ChaosInjector(seed=11)
        inj.arm("dist.kill", at=1, payload="w0")
        chaos.install(inj)
        assert sup.maybe_kill("w0")
        argv, _ = worker_argv("w0", recover=True, resume_t=fed.clock.t,
                              port=port0)
        sup.restart("w0", argv=argv, timeout=READY_S)
        for _ in range(5):
            fed.step()
            ctl.step()
            jctl.step()
        dg = fed.digests()
        assert dg["manager"] == state_digest(ctl.manager)
        assert dg["manager"] == jax_digest(jctl.manager)
        for n in urls:
            assert dg["workers"][n] == state_digest(ctl.workers[n])
            assert dg["workers"][n] == jax_digest(jctl.workers[n])
        assert fed.violations == [] and ctl.violations == []
        assert fed.settled() and ctl.settled()
        assert fed.client_stats()["w0"]["epoch_resyncs"] >= 1
    finally:
        sup.terminate_all()


def test_shard_journal_replay_offline(tmp_path):
    """A shard rebuilt from its on-disk journals alone reaches the digest
    of the service that wrote them, and the JAX package's service fed
    the same payloads reaches it too."""
    from kueue_tpu.dist.serving import build_shard_service as jax_build
    from kueue_tpu.remote import state_digest as jax_digest
    from kueue_tpu_torch.dist.serving import recover_shard_service
    tmp = str(tmp_path)
    os.makedirs(f"{tmp}/jax")
    svc, _clock = build_shard_service(0, N_CQS, tmp, device="cpu")
    jsvc, _ = jax_build(0, N_CQS, f"{tmp}/jax")
    for s in range(3):
        for b in step_payloads(s, 0, 1, PER_STEP, N_CQS):
            for x in (svc, jsvc):
                x.submit(name=b["name"], queue_name=b["queue_name"],
                         requests=b["requests"], priority=b["priority"],
                         namespace=b["namespace"],
                         runtime_s=b["runtime_s"], count=b["count"],
                         token=b["token"])
        assert svc.step()["decisions"] == jsvc.step()["decisions"]
    want = state_digest(svc.driver)
    assert jax_digest(jsvc.driver) == want
    rec, _clock2 = recover_shard_service(0, N_CQS, tmp, resume_cycle=3,
                                         device="cpu")
    assert state_digest(rec.driver) == want
    assert rec.cycle_index == svc.cycle_index


# -- the port's own: argv, the card, phase 23's arms ------------------------

def test_child_argv_spawns_the_port():
    """Every role's argv runs the port's child module with the device
    asked; none names a module of the JAX package."""
    for role in ("shard", "worker", "submitter"):
        argv = child_argv(role, device="cpu", port=0)
        assert argv[1:3] == ["-m", "kueue_tpu_torch.dist.child"]
        assert argv[argv.index("--device") + 1] == "cpu"
        assert not any(a == "kueue_tpu" or a.startswith("kueue_tpu.")
                       for a in argv)
    from kueue_tpu_torch.dist import child
    assert child.main.__module__ == "kueue_tpu_torch.dist.child"


def test_child_without_a_card_dies_and_is_reported(tmp_path):
    """A shard child left at its default ``--device cuda``: without a
    usable GPU its Driver raises, the child dies before it binds, and
    ``wait_ready`` surfaces that instead of carrying on on the CPU."""
    tmp = str(tmp_path)
    pf = f"{tmp}/shard0.port"
    argv = child_argv("shard", shard_id=0, n_cqs=N_CQS, state_dir=tmp,
                      port_file=pf)
    assert "--device" not in argv
    sup = ProcessSupervisor(seed=11)
    mp = sup.spawn("shard0", "shard", argv, port_file=pf)
    try:
        if torch.cuda.is_available():
            assert sup.wait_ready(mp, timeout=READY_S) > 0
        else:
            with pytest.raises(RuntimeError, match="no CUDA GPU"):
                sup.wait_ready(mp, timeout=READY_S)
            assert not mp.alive
    finally:
        sup.terminate_all()


DIST_CFG = dict(cqs=8, shards=2, submitters=2, workers=2, per_step=3,
                kill_steps=4, fed_cqs=6, fed_remote_cqs=4,
                fed_traffic_steps=3, fed_pre_kill_steps=3,
                fed_post_kill_steps=4, proxy_reset=0.03,
                proxy_latency=0.05, ready_timeout_s=READY_S)


def test_phase23_arms_on_the_cpu(tmp_path):
    """chip_smoke.py phase 23's arms on the CPU at dist_soak.py's quick
    size: the shard kill and the federation-worker kill recover with
    decisions and digests equal to their controls, zero lost, zero
    duplicated; every child ran the port's module on "cpu" and reported
    its steps through ``--stats-file``."""
    pids = {}
    shard = scenarios.dist_kill_front_end_shard(
        DIST_CFG, 2004, str(tmp_path), device="cpu",
        while_running=lambda sup: pids.update(
            {n: mp.proc.pid for n, mp in sup.procs.items()}) or pids)
    assert shard["ok"], {k: shard[k] for k in ("killed", "lost",
                                                "duplicated", "dedupe")}
    assert shard["admissions"] > 0
    fed = scenarios.dist_kill_federation_worker(DIST_CFG, 2006,
                                                str(tmp_path), device="cpu")
    assert fed["ok"], {k: fed[k] for k in ("manager_parity",
                                            "worker_parity", "settled")}
    for r in (shard, fed):
        for argv in r["argvs"]:
            assert argv[2] == "kueue_tpu_torch.dist.child"
            if "--role" in argv and argv[argv.index("--role") + 1] != \
                    "submitter":
                assert argv[argv.index("--device") + 1] == "cpu"
        for name, st in r["child_stats"].items():
            assert st is not None, name
            assert st["cuda_initialized"] is False
            assert sum(st["launches"].values()) == 0
    assert set(pids) == {"shard0", "shard1", "sub0", "sub1"}
