"""The kueuectl CLI, its debugger and its daemon in the port, held to the
JAX package's: the same commands on two state directories — the
reference's ``kueue_tpu.cli.main`` on one, the port's ``main(["--device",
"cpu", ...])`` on the other — must print the same text and leave the same
``state.json`` (the conditions' ``lastTransitionTime``, set from the
Driver's wall clock, left out).  Twins of tests/test_cli_visibility.py's
CLI and debugger tests and tests/test_daemon.py's daemon, SIGUSR2, lease
and serve-drain tests, plus the port's own: ``--device`` (the card by
default, raising without one), ``--device-solver`` accepted with equal
decisions either way, the store watcher's thread never deciding a cycle,
and MultiKueue workers as ``python -m kueue_tpu_torch.cli serve
--listen`` processes."""

from __future__ import annotations

import io
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import threading
import time

import pytest
import torch

import kueue_tpu.cli as ref_cli
import kueue_tpu_torch.cli as port_cli
from kueue_tpu_torch import scenarios

torch.set_num_threads(1)

SETUP_YAML = """
apiVersion: kueue.x-k8s.io/v1beta1
kind: ResourceFlavor
metadata:
  name: default-flavor
---
apiVersion: kueue.x-k8s.io/v1beta1
kind: ClusterQueue
metadata:
  name: cluster-queue
spec:
  namespaceSelector: {}
  resourceGroups:
  - coveredResources: ["cpu", "memory"]
    flavors:
    - name: "default-flavor"
      resources:
      - name: "cpu"
        nominalQuota: 9
      - name: "memory"
        nominalQuota: 36Gi
---
apiVersion: kueue.x-k8s.io/v1beta1
kind: LocalQueue
metadata:
  namespace: default
  name: user-queue
spec:
  clusterQueue: cluster-queue
"""

WORKLOAD_YAML = """
apiVersion: kueue.x-k8s.io/v1beta1
kind: Workload
metadata:
  name: job-{i}
  namespace: default
spec:
  queueName: user-queue
  podSets:
  - name: main
    count: 1
    template:
      spec:
        containers:
        - name: c
          resources:
            requests:
              cpu: "2"
              memory: 4Gi
"""

PODS_YAML = """
apiVersion: v1
kind: Pod
metadata:
  name: running-1
  labels:
    kueue.x-k8s.io/queue-name: user-queue
spec:
  containers:
  - name: c
    resources:
      requests:
        cpu: "1"
---
apiVersion: v1
kind: Pod
metadata:
  name: no-queue
spec:
  containers:
  - name: c
    resources:
      requests:
        cpu: "1"
"""

DAEMON_SETUP = """
apiVersion: kueue.x-k8s.io/v1beta1
kind: ResourceFlavor
metadata:
  name: default
---
apiVersion: kueue.x-k8s.io/v1beta1
kind: ClusterQueue
metadata:
  name: cq
spec:
  resourceGroups:
  - coveredResources: ["cpu"]
    flavors:
    - name: "default"
      resources:
      - name: "cpu"
        nominalQuota: 8
---
apiVersion: kueue.x-k8s.io/v1beta1
kind: LocalQueue
metadata:
  namespace: default
  name: lq
spec:
  clusterQueue: cq
"""

DAEMON_WORKLOAD = """
apiVersion: kueue.x-k8s.io/v1beta1
kind: Workload
metadata:
  namespace: default
  name: job-{i}
spec:
  queueName: lq
  podSets:
  - name: main
    count: 1
    template:
      spec:
        containers:
        - resources:
            requests:
              cpu: 1
"""


def store_docs(state_dir):
    """Every document of a store, in order, without lastTransitionTime."""
    with open(os.path.join(state_dir, "state.json")) as fh:
        docs = json.load(fh)
    for doc in docs:
        for c in (doc.get("status") or {}).get("conditions", []):
            c.pop("lastTransitionTime", None)
    return docs


class Twin:
    """One state directory per package; ``run`` drives both CLIs."""

    def __init__(self, tmp_path, capsys):
        self.ref = str(tmp_path / "ref")
        self.port = str(tmp_path / "port")
        self.capsys = capsys

    def run(self, *argv):
        """The same command on both packages: equal exit codes, equal
        output (each directory's path made the same), equal stores."""
        self.capsys.readouterr()
        rc_r = ref_cli.main(["--state-dir", self.ref, *argv])
        out_r = self.capsys.readouterr().out.replace(self.ref, "<state>")
        rc_p = port_cli.main(["--state-dir", self.port, "--device", "cpu",
                              *argv])
        out_p = self.capsys.readouterr().out.replace(self.port, "<state>")
        assert (rc_p, out_p) == (rc_r, out_r)
        if os.path.exists(os.path.join(self.ref, "state.json")):
            assert store_docs(self.port) == store_docs(self.ref)
        return rc_p, out_p


def write(tmp_path, name, text):
    path = tmp_path / name
    path.write_text(text)
    return str(path)


# ---------------------------------------------------------------------------
# twins of tests/test_cli_visibility.py
# ---------------------------------------------------------------------------

def test_cli_end_to_end_matches_the_reference(tmp_path, capsys):
    tw = Twin(tmp_path, capsys)
    setup = write(tmp_path, "setup.yaml", SETUP_YAML)
    jobs = write(tmp_path, "jobs.yaml", "\n---\n".join(
        WORKLOAD_YAML.format(i=i) for i in range(6)))
    assert tw.run("apply", "-f", setup)[0] == 0
    assert tw.run("apply", "-f", jobs)[0] == 0
    _, out = tw.run("schedule")
    assert "admitted 4 workloads" in out          # 9 CPUs / 2 per job
    _, out = tw.run("list", "workload")
    assert out.count("Admitted") == 4 and out.count("Pending") == 2
    tw.run("list", "cq")
    # restart from disk: replay keeps prior admissions
    d = port_cli.build_driver(port_cli.Store(tw.port), device="cpu")
    r = ref_cli.build_driver(ref_cli.Store(tw.ref))
    assert sorted(d.admitted_keys()) == sorted(r.admitted_keys())
    assert len(d.admitted_keys()) == 4
    assert tw.run("delete", "workload", "job-0")[0] == 0
    assert tw.run("delete", "workload", "job-1")[0] == 0
    assert "admitted 4 workloads" in tw.run("schedule")[1]
    tw.run("state")


def test_cli_create_and_stop_resume_match_the_reference(tmp_path, capsys):
    tw = Twin(tmp_path, capsys)
    assert tw.run("create", "resourceflavor", "default", "--node-labels",
                  "zone=a")[0] == 0
    assert tw.run("create", "clusterqueue", "cq", "--nominal-quota",
                  "cpu=10")[0] == 0
    assert tw.run("create", "localqueue", "lq", "--clusterqueue",
                  "cq")[0] == 0
    assert tw.run("stop", "clusterqueue", "cq")[0] == 0
    assert port_cli.Store(tw.port).get("ClusterQueue", "cq")["spec"][
        "stopPolicy"] == "HoldAndDrain"
    assert tw.run("resume", "clusterqueue", "cq")[0] == 0
    assert port_cli.Store(tw.port).get("ClusterQueue", "cq")["spec"][
        "stopPolicy"] == "None"
    assert tw.run("version")[1].strip() == ref_cli.VERSION


def test_cli_import_pods_matches_the_reference(tmp_path, capsys):
    tw = Twin(tmp_path, capsys)
    tw.run("apply", "-f", write(tmp_path, "setup.yaml", SETUP_YAML))
    _, out = tw.run("import", "-f", write(tmp_path, "pods.yaml", PODS_YAML))
    assert "imported 1 pods (1 skipped)" in out
    d = port_cli.build_driver(port_cli.Store(tw.port), device="cpu")
    assert "default/pod-running-1" in d.admitted_keys()


@pytest.mark.parametrize("device_solver", [False, True])
def test_device_solver_flag_decides_as_the_reference(tmp_path, capsys,
                                                     device_solver):
    """``--device-solver`` is accepted and changes nothing in the port,
    whose Drivers always decide with the device solver; the reference
    decides with its host path without the flag and its device solver
    with it; both give the port's store.  The perf scenario's cluster
    (5 cohorts x 6 CQs, preemption on) with 300 workloads."""
    tw = Twin(tmp_path, capsys)
    docs = scenarios.cli_bench_docs(0.02)
    bench = scenarios.write_manifests(str(tmp_path / "bench.yaml"), docs)
    flag = ("--device-solver",) if device_solver else ()
    tw.run("apply", "-f", bench)
    _, out = tw.run("schedule", *flag, "--cycles", "200")
    assert out.startswith("admitted 30 workloads")
    # and the port with the flag the other way round: the same store
    other = str(tmp_path / "other")
    capsys.readouterr()
    port_cli.main(["--state-dir", other, "--device", "cpu", "apply", "-f",
                   bench])
    capsys.readouterr()
    port_cli.main(["--state-dir", other, "--device", "cpu", "schedule",
                   *(() if device_solver else ("--device-solver",)),
                   "--cycles", "200"])
    assert capsys.readouterr().out == out
    assert store_docs(other) == store_docs(tw.ref)


def test_cli_schedule_device_solver_admits(tmp_path, capsys):
    """Manifest-decoded CQs (borrowWithinCohort unset) through
    ``schedule --device-solver`` on both packages."""
    tw = Twin(tmp_path, capsys)
    tw.run("apply", "-f", write(tmp_path, "setup.yaml", SETUP_YAML + """
---
apiVersion: kueue.x-k8s.io/v1beta1
kind: Workload
metadata:
  namespace: default
  name: dev-job
spec:
  queueName: user-queue
  podSets:
  - name: main
    count: 1
    template:
      spec:
        containers:
        - resources:
            requests:
              cpu: 2
"""))
    tw.run("schedule", "--device-solver", "--cycles", "5")
    doc = port_cli.Store(tw.port).get("Workload", "dev-job")
    conds = {c["type"]: c["status"]
             for c in (doc.get("status") or {}).get("conditions", [])}
    assert conds.get("QuotaReserved") == "True", doc


def _pending_drivers():
    """tests/test_cli_visibility.py make_driver_with_pending on both
    packages (the port's on "cpu")."""
    out = []
    for root in ("kueue_tpu", "kueue_tpu_torch"):
        t = __import__(f"{root}.api.types", fromlist=["x"])
        Driver = __import__(f"{root}.controller.driver",
                            fromlist=["x"]).Driver
        d = (Driver(clock=lambda: 1000.0) if root == "kueue_tpu"
             else Driver(clock=lambda: 1000.0, device="cpu"))
        d.apply_resource_flavor(t.ResourceFlavor(name="default"))
        d.apply_cluster_queue(t.ClusterQueue(
            name="cq", resource_groups=[t.ResourceGroup(
                covered_resources=["cpu"],
                flavors=[t.FlavorQuotas(name="default", resources={
                    "cpu": t.ResourceQuota(nominal=1000)})])]))
        d.apply_local_queue(t.LocalQueue(name="lq", cluster_queue="cq"))
        for i in range(4):
            d.create_workload(t.Workload(
                name=f"w{i}", queue_name="lq", priority=i,
                creation_time=float(i + 1),
                pod_sets=[t.PodSet(name="main", count=1,
                                   requests={"cpu": 1000})]))
        d.run_until_settled()
        out.append(d)
    return out


def test_debugger_dump_is_the_references_character_for_character():
    from kueue_tpu.debugger import dump_state as ref_dump
    from kueue_tpu_torch.debugger import dump_state
    ref, port = _pending_drivers()
    text = dump_state(port)
    assert "cq: 3 pending" in text and "default/w3" in text
    assert text == ref_dump(ref)
    out = io.StringIO()
    assert dump_state(port, out=out, flight_tail=2) == \
        ref_dump(ref, flight_tail=2)
    assert out.getvalue() == ref_dump(ref, flight_tail=2) + "\n"


def test_cli_profile_dir_writes_a_torch_profiler_trace(tmp_path, capsys):
    """``schedule --profile-dir`` traces through the port's
    ``profiling.trace`` (torch.profiler): a Chrome trace in the
    directory; the help text names no JAX profiler."""
    state, prof = str(tmp_path / "s"), str(tmp_path / "prof")
    port_cli.main(["--state-dir", state, "--device", "cpu", "apply", "-f",
                   write(tmp_path, "setup.yaml", SETUP_YAML)])
    assert port_cli.main(["--state-dir", state, "--device", "cpu",
                          "schedule", "--profile-dir", prof]) == 0
    with open(os.path.join(prof, "trace.json")) as fh:
        assert "traceEvents" in json.load(fh)
    capsys.readouterr()
    for cmd in ("schedule", "serve"):
        with pytest.raises(SystemExit):
            port_cli.main([cmd, "--help"])
        text = capsys.readouterr().out
        assert "torch.profiler" in text and "jax" not in text


# ---------------------------------------------------------------------------
# --device: the card by default, no CPU fallback
# ---------------------------------------------------------------------------

@pytest.mark.skipif(torch.cuda.is_available(), reason="a GPU is present")
@pytest.mark.parametrize("cmd", [["schedule"], ["state"], ["list", "cq"],
                                 ["serve", "--exit-when-drained"]])
def test_device_cuda_raises_without_a_gpu(tmp_path, cmd):
    state = str(tmp_path / "s")
    port_cli.main(["--state-dir", state, "--device", "cpu", "apply", "-f",
                   write(tmp_path, "setup.yaml", SETUP_YAML)])
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        port_cli.main(["--state-dir", state, *cmd])
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        port_cli.main(["--state-dir", state, "--device", "cuda", *cmd])
    # a refused serve leaves the lease free
    from kueue_tpu_torch.leaderelection import FileLease
    lease = FileLease(state)
    assert lease.try_acquire()
    lease.release()


@pytest.mark.skipif(torch.cuda.is_available(), reason="a GPU is present")
def test_device_defaults_to_cuda_in_a_fresh_process(tmp_path):
    """``python -m kueue_tpu_torch.cli apply`` without ``--device`` builds
    its Driver on the card and exits non-zero here."""
    setup = write(tmp_path, "setup.yaml", SETUP_YAML)
    cwd, env = scenarios.cli_env()
    r = subprocess.run([sys.executable, "-m", "kueue_tpu_torch.cli",
                        "--state-dir", str(tmp_path / "s"), "apply", "-f",
                        setup], cwd=cwd, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0 and "no CUDA GPU" in r.stderr, r.stderr[-2000:]


# ---------------------------------------------------------------------------
# twins of tests/test_daemon.py
# ---------------------------------------------------------------------------

def _daemon_driver():
    from kueue_tpu_torch.api.types import (ClusterQueue, FlavorQuotas,
                                           LocalQueue, ResourceFlavor,
                                           ResourceGroup, ResourceQuota)
    from kueue_tpu_torch.controller.driver import Driver
    d = Driver(device="cpu")   # real clock: the daemon runs on wall time
    d.apply_resource_flavor(ResourceFlavor(name="default"))
    d.apply_cluster_queue(ClusterQueue(
        name="cq",
        resource_groups=[ResourceGroup(covered_resources=["cpu"], flavors=[
            FlavorQuotas(name="default", resources={
                "cpu": ResourceQuota(nominal=2000)})])]))
    d.apply_local_queue(LocalQueue(name="lq", cluster_queue="cq"))
    return d


def _wl(name, t):
    from kueue_tpu_torch.api.types import PodSet, Workload
    return Workload(name=name, queue_name="lq", creation_time=t,
                    pod_sets=[PodSet(name="m", count=1,
                                     requests={"cpu": 1000})])


def test_daemon_admits_producer_workloads():
    """The port's daemon loop admits workloads another thread creates as
    quota allows, on "cpu"."""
    d = _daemon_driver()
    stop = threading.Event()
    daemon = threading.Thread(target=d.run, args=(stop,), daemon=True)
    daemon.start()
    try:
        total = 6
        admitted_ever: set[str] = set()
        deadline = time.monotonic() + 30.0
        for i in range(total):
            d.create_workload(_wl(f"wl-{i}", float(i)))
        while len(admitted_ever) < total and time.monotonic() < deadline:
            for key in list(d.admitted_keys()):
                admitted_ever.add(key)
                d.finish_workload(key)
            time.sleep(0.01)
        assert len(admitted_ever) == total, admitted_ever
    finally:
        stop.set()
        daemon.join(timeout=5.0)
    assert not daemon.is_alive()


def test_daemon_sigusr2_dump_while_serving():
    from kueue_tpu_torch.debugger import Dumper
    d = _daemon_driver()
    out = io.StringIO()
    Dumper(d, out=out).listen_for_signal()
    stop = threading.Event()
    daemon = threading.Thread(target=d.run, args=(stop,), daemon=True)
    daemon.start()
    try:
        d.create_workload(_wl("live", 1.0))
        deadline = time.monotonic() + 10.0
        while not d.admitted_keys() and time.monotonic() < deadline:
            time.sleep(0.01)
        os.kill(os.getpid(), signal.SIGUSR2)
        time.sleep(0.2)
    finally:
        stop.set()
        daemon.join(timeout=5.0)
        signal.signal(signal.SIGUSR2, signal.SIG_DFL)
    text = out.getvalue()
    assert "cq" in text and "default/live" in text, text


def test_leader_election_file_lease(tmp_path):
    from kueue_tpu_torch.leaderelection import FileLease
    a = FileLease(str(tmp_path))
    b = FileLease(str(tmp_path))
    assert a.try_acquire()
    assert not b.try_acquire()
    stop = threading.Event()
    stop.set()
    assert not b.acquire(stop)
    a.release()
    assert b.try_acquire()
    b.release()


def test_cli_serve_drains_store_as_the_reference(tmp_path, capsys):
    """``serve --exit-when-drained`` admits every stored workload and
    writes status back; the port's store equals the reference's."""
    tw = Twin(tmp_path, capsys)
    setup = write(tmp_path, "setup.yaml", DAEMON_SETUP + "".join(
        "---" + DAEMON_WORKLOAD.format(i=i) for i in range(5)))
    tw.run("apply", "-f", setup)
    rc, out = tw.run("serve", "--exit-when-drained", "--poll-interval",
                     "0.05")
    assert rc == 0 and "serve exiting: 5 workloads holding quota" in out
    for doc in port_cli.Store(tw.port).by_kind("Workload"):
        conds = {c["type"]: c["status"]
                 for c in (doc.get("status") or {}).get("conditions", [])}
        assert conds.get("QuotaReserved") == "True", doc


def test_store_watcher_never_decides_a_cycle(tmp_path):
    """``cli serve`` with its store watcher restoring workloads that
    another thread applies: every ``solver.dispatch`` (the call that
    launches the admit kernels on the card) comes from the daemon's
    thread, none from the watcher's or the applier's."""
    docs = scenarios.cli_bench_docs(0.02)
    state = str(tmp_path / "s")
    port_cli.main(["--state-dir", state, "--device", "cpu", "apply", "-f",
                   scenarios.write_manifests(
                       str(tmp_path / "cluster.yaml"),
                       [d for d in docs if d["kind"] != "Workload"])])
    extra = scenarios.write_manifests(str(tmp_path / "serve.yaml"),
                                      scenarios.cli_serve_docs(20))
    new = [f"default/serve-{i}" for i in range(20)]
    r = scenarios.cli_serve_in_process(state, extra, "cpu", new)
    assert r["rc"] == 0 and r["error"] is None, r["error"]
    assert set(new) <= set(r["driver"].admitted_keys())
    assert set(r["dispatches"]) == {r["serve_thread"]}
    assert sum(r["dispatches"].values()) >= 1
    held = {d["metadata"]["name"] for d in store_docs(state)
            if d["kind"] == "Workload" and d["status"].get("admission")}
    assert held == {k.split("/")[1] for k in new}


# ---------------------------------------------------------------------------
# the scenario helpers behind chip_smoke.py's phase 24
# ---------------------------------------------------------------------------

def test_bench_manifests_decode_to_the_perf_scenario():
    """``cli_bench_docs`` decodes to ``bench_objects``' ClusterQueues and
    workloads (preemption policy included)."""
    from kueue_tpu_torch.api.manifests import from_manifest
    flavor, queues, waves, total = scenarios.bench_objects(0.02)
    docs = scenarios.cli_bench_docs(0.02)
    cqs = [from_manifest(d) for d in docs if d["kind"] == "ClusterQueue"]
    for got, (want, _) in zip(cqs, queues, strict=True):
        assert (got.name, got.cohort, got.preemption,
                got.resource_groups) == (want.name, want.cohort,
                                         want.preemption,
                                         want.resource_groups)
    wls = [from_manifest(d) for d in docs if d["kind"] == "Workload"]
    assert len(wls) == total == 300
    want = sorted((w for ws in waves.values() for w in ws),
                  key=lambda w: w.creation_time)
    assert [(w.name, w.priority, w.creation_time, w.pod_sets[0].requests)
            for w in wls] == [(w.name, w.priority, w.creation_time,
                               w.pod_sets[0].requests) for w in want]


def test_serve_sequence_hands_over_the_lease(tmp_path, capsys):
    """chip_smoke.py's phase 24 (d) at 300 workloads on "cpu": the
    leader's watcher admits what is applied while it serves (its
    SIGUSR2 dump lists them), SIGTERM makes it write back and free the
    lease, the waiter drains and exits 0; twice, with one digest."""
    docs = scenarios.cli_bench_docs(0.02)
    bench = scenarios.write_manifests(str(tmp_path / "bench.yaml"), docs)
    extra = scenarios.write_manifests(str(tmp_path / "serve.yaml"),
                                      scenarios.cli_serve_docs(20))
    new = [f"default/serve-{i}" for i in range(20)]
    base = str(tmp_path / "base")
    port_cli.main(["--state-dir", base, "--device", "cpu", "apply", "-f",
                   bench])
    port_cli.main(["--state-dir", base, "--device", "cpu", "schedule"])
    admitted = capsys.readouterr().out.splitlines()[-30:]
    digests = []
    for run in range(2):
        state = str(tmp_path / f"run{run}")
        shutil.copytree(base, state)
        r = scenarios.cli_serve_sequence(state, extra, "cpu", new,
                                         timeout=240.0)
        assert r["ok"] and r["rc"] == {"leader": 0, "waiter": 0}, r
        assert r["admitted_in_dump"] == 20
        assert r["waiter_out"][0].startswith("waiting for leadership")
        assert r["leader_out"][-1] == "serve exiting: 50 workloads " \
                                      "holding quota"
        held = {f"default/{d['metadata']['name']}" for d in store_docs(state)
                if d["kind"] == "Workload"
                and (d.get("status") or {}).get("admission")}
        assert held == {a.strip() for a in admitted} | set(new)
        digests.append(r["digest"])
    assert digests[0] == digests[1]


# ---------------------------------------------------------------------------
# twin of tests/test_multikueue_transport.py::test_multikueue_over_http_processes
# ---------------------------------------------------------------------------

def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_worker(tmp_path, name, port):
    state = str(tmp_path / name)
    setup = write(tmp_path, f"{name}-setup.yaml", DAEMON_SETUP)
    cwd, env = scenarios.cli_env()
    subprocess.run(scenarios.cli_argv(state, "cpu", "apply", "-f", setup),
                   check=True, cwd=cwd, env=env, capture_output=True,
                   timeout=300)
    return subprocess.Popen(
        scenarios.cli_argv(state, "cpu", "serve", "--listen", str(port),
                           "--poll-interval", "0.1"),
        cwd=cwd, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)


def wait_healthy(client, proc, deadline):
    while time.monotonic() < deadline and proc.poll() is None:
        if client.healthy():
            return True
        time.sleep(0.1)
    return False


def until(deadline, fn, step):
    """Call ``step`` until ``fn()`` holds or the deadline passes."""
    while time.monotonic() < deadline:
        if fn():
            return True
        step()
        time.sleep(0.1)
    return fn()


def test_multikueue_over_http_to_port_cli_workers(tmp_path):
    """Two workers, each ``python -m kueue_tpu_torch.cli ... serve
    --listen P --device cpu``: dispatch, first reservation wins, remote
    finish copied back, the holder killed, ejected and the workload
    re-dispatched to the survivor.  Health is polled until a deadline
    well past a worker's start, and the test ends by its own deadline."""
    from kueue_tpu_torch.admissionchecks.multikueue import (
        MultiKueueController, WorkerCluster)
    from kueue_tpu_torch.api.types import (
        AdmissionCheck, AdmissionCheckState, ClusterQueue, FlavorQuotas,
        LocalQueue, MultiKueueConfig, PodSet, ResourceFlavor, ResourceGroup,
        ResourceQuota, Workload)
    from kueue_tpu_torch.controller.driver import Driver
    from kueue_tpu_torch.remote import HttpWorkerClient

    end = time.monotonic() + 240.0
    ports = [free_port(), free_port()]
    procs = [start_worker(tmp_path, f"worker-{i}", p)
             for i, p in enumerate(ports)]
    try:
        clients = [HttpWorkerClient(f"http://127.0.0.1:{p}") for p in ports]
        for c, p in zip(clients, procs):
            assert wait_healthy(c, p, min(end, time.monotonic() + 120.0)), \
                "worker process never became healthy"
        manager = Driver(device="cpu")
        manager.apply_resource_flavor(ResourceFlavor(name="default"))
        manager.apply_admission_check(AdmissionCheck(
            name="mk", controller_name="kueue.x-k8s.io/multikueue"))
        manager.apply_cluster_queue(ClusterQueue(
            name="cq", admission_checks=["mk"],
            resource_groups=[ResourceGroup(
                covered_resources=["cpu"], flavors=[FlavorQuotas(
                    name="default", resources={
                        "cpu": ResourceQuota(nominal=8000)})])]))
        manager.apply_local_queue(LocalQueue(name="lq", cluster_queue="cq"))
        clusters = {f"worker-{i}": WorkerCluster(name=f"worker-{i}",
                                                 client=c)
                    for i, c in enumerate(clients)}
        ctrl = MultiKueueController(
            manager, check_name="mk",
            config=MultiKueueConfig(name="mk-config",
                                    clusters=list(clusters)),
            clusters=clusters, worker_lost_timeout=2.0)

        def ready(key):
            st = manager.workloads[key].admission_check_states["mk"]
            return st.state == AdmissionCheckState.READY

        manager.create_workload(Workload(
            name="train", queue_name="lq", creation_time=1.0,
            pod_sets=[PodSet(name="main", count=1,
                             requests={"cpu": 2000})]))
        manager.schedule_once()
        key = "default/train"
        assert manager.workloads[key].has_quota_reservation
        assert until(min(end, time.monotonic() + 60.0), lambda: ready(key),
                     ctrl.reconcile)
        holder = ctrl.assignments[key].cluster
        other = next(n for n in clusters if n != holder)
        assert key not in clusters[other].client.list_workload_keys()

        clusters[holder].client.finish_workload(key, "done on worker")
        assert until(min(end, time.monotonic() + 60.0),
                     lambda: manager.workloads[key].is_finished,
                     ctrl.reconcile)

        manager.create_workload(Workload(
            name="retry", queue_name="lq", creation_time=2.0,
            pod_sets=[PodSet(name="main", count=1,
                             requests={"cpu": 1000})]))
        manager.schedule_once()
        key2 = "default/retry"
        assert until(min(end, time.monotonic() + 60.0),
                     lambda: ready(key2), ctrl.reconcile)
        holder2 = ctrl.assignments[key2].cluster
        hi = int(holder2.split("-")[1])
        procs[hi].send_signal(signal.SIGKILL)
        procs[hi].wait(timeout=30)
        survivor = next(n for n in clusters if n != holder2)

        def step():
            manager.schedule_once()
            ctrl.reconcile()

        assert until(
            min(end, time.monotonic() + 60.0),
            lambda: (ctrl.assignments.get(key2) is not None
                     and ctrl.assignments[key2].cluster == survivor),
            step), (ctrl.assignments.get(key2),
                    [(n, c.active) for n, c in clusters.items()])
        assert not clusters[holder2].active
        assert clusters[holder2].retry_backoff > 1.0
        assert key2 in clusters[survivor].client.list_workload_keys()
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
                try:
                    p.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
