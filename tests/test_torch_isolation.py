"""kueue_tpu_torch stands alone: it imports neither JAX nor anything of
kueue_tpu, its host-plane modules are the JAX package's files byte for
byte (except the listed ones), and its Driver runs on the card by
default — raising, never falling back, when there is none."""

import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "kueue_tpu_torch")

# host-plane modules carried over unchanged from kueue_tpu/
VERBATIM = (
    "resources.py", "workload.py", "hierarchy.py", "limitrange.py",
    "features.py", "metrics.py", "wait.py",
    "api/__init__.py", "api/types.py", "api/quantity.py",
    "cache/__init__.py", "cache/cache.py", "cache/snapshot.py",
    "cache/state.py", "cache/resource_node.py",
    "chaos/__init__.py", "chaos/injector.py",
    "obs/__init__.py", "obs/trace.py", "obs/flight.py", "obs/events.py",
    "queue/__init__.py", "queue/manager.py", "queue/cluster_queue.py",
    "scheduler/__init__.py", "scheduler/scheduler.py",
    "scheduler/preemption.py", "scheduler/flavorassigner.py",
    "scheduler/fairsharing.py",
    "utils/__init__.py", "utils/heap.py", "utils/journal.py",
    "utils/parallel_host.py",
    "webhooks/__init__.py", "webhooks/validation.py",
    "controller/__init__.py", "controller/tas_ungater.py",
    "ops/aggregate.py", "ops/stream_pack.py", "cache/arena.py",
)
# copies that begin with the original file and only append to it
APPENDED = ("ops/packing.py",)
# copies edited where they reached JAX or ops/ (CHANGES.md lists each)
EDITED = ("controller/driver.py", "ops/preemption_solver.py", "ops/burst.py",
          "cache/tas_snapshot.py", "cache/tas_cache.py")


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("rel", VERBATIM)
def test_verbatim_copies(rel):
    assert _read(os.path.join(PORT, rel)) == _read(
        os.path.join(ROOT, "kueue_tpu", rel)), rel


@pytest.mark.parametrize("rel", APPENDED)
def test_appended_copies(rel):
    port = _read(os.path.join(PORT, rel))
    orig = _read(os.path.join(ROOT, "kueue_tpu", rel))
    assert port.startswith(orig) and len(port) > len(orig), rel


def _port_files():
    for dirpath, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_every_port_module_is_accounted_for():
    """Each module of the port is a verbatim, appended or edited copy, or
    one of the port's own rewritten modules."""
    own = {"__init__.py", "ops/__init__.py", "ops/quota_kernel.py",
           "ops/cycle.py", "ops/preemption_kernel.py", "ops/solver.py",
           "ops/fs_scan.py", "ops/fairsharing_kernel.py",
           "ops/tas_kernel.py", "profiling.py", "kernels/__init__.py", "scenarios.py",
           "testing.py"}
    rels = {os.path.relpath(p, PORT) for p in _port_files()}
    assert rels == set(VERBATIM) | set(APPENDED) | set(EDITED) | own


def test_no_jax_or_kueue_tpu_import():
    """An AST scan of every module: no import of jax/jaxlib/flax or of
    kueue_tpu (absolute), at any depth of the file."""
    bad = []
    for path in _port_files():
        tree = ast.parse(_read(path), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                if top in ("jax", "jaxlib", "flax", "kueue_tpu"):
                    bad.append((os.path.relpath(path, ROOT), n))
    assert not bad, bad


def test_runtime_modules_in_a_fresh_process():
    """Importing the port and running device-decided CPU cycles (with
    preemption searches) loads neither jax nor kueue_tpu."""
    code = (
        "import sys\n"
        "from kueue_tpu_torch import scenarios\n"
        "d, c, total, waves = scenarios.build_bench(0.01, device='cpu')\n"
        "r = scenarios.run_bench(d, c, total, waves)\n"
        "assert r['finished'] == total and r['preempted'] > 0, r\n"
        "assert d.scheduler.solver.stats['full_cycles'] > 0\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'kueue_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


def test_driver_defaults_to_the_card():
    from kueue_tpu_torch.controller.driver import Driver
    if torch.cuda.is_available():
        d = Driver()
        assert d.scheduler.solver.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            Driver()
        with pytest.raises(RuntimeError):
            Driver(device="cuda")
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            Driver(fair_sharing=True)
    assert Driver(device="cpu").scheduler.solver.device.type == "cpu"
    d = Driver(device="cpu", fair_sharing=True)
    assert d.scheduler.fair_sharing and d.scheduler.solver.device.type == "cpu"


def test_fair_sharing_drain_in_a_fresh_process():
    """A fair-sharing drain on "cpu" (the north-star FS scenario, small)
    decides cycles in the fs_admit_scan path and loads neither jax nor
    kueue_tpu."""
    code = (
        "import sys\n"
        "from kueue_tpu_torch import scenarios\n"
        "d, c, total = scenarios.build_northstar_fs(20, 400, device='cpu')\n"
        "r = scenarios.run_northstar_fs(d, c, cycles=12)\n"
        "assert r['admitted'] > 0, r\n"
        "assert d.scheduler.solver.stats['fs_full_cycles'] > 0\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'kueue_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


def test_unported_paths_raise(monkeypatch):
    from kueue_tpu_torch.controller.driver import Driver
    monkeypatch.setenv("KUEUE_TPU_SHARDS", "2")
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        Driver(device="cpu")


def test_cpu_tensors_never_reach_the_kernels():
    """On CPU tensors the routed entry points run the plain versions and
    launch nothing."""
    import numpy as np
    from kueue_tpu_torch import kernels, testing
    from kueue_tpu_torch.ops import cycle
    before = dict(kernels.LAUNCHES)
    c = testing.admit_cycle(np.random.default_rng(0))
    args = [torch.from_numpy(a) for a in testing.admit_args(c)]
    assert cycle.admit_scan(*args, depth=c["depth"]).dtype == torch.bool
    assert kernels.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.admit_scan(*args, depth=c["depth"])


def test_burst_runs_on_the_drivers_device_only():
    """schedule_burst runs on the Driver's device: on "cuda" without a
    GPU it raises (the Driver cannot even be built), its BurstSolver
    never selects the CPU, and a ``backend`` naming another device
    raises instead of moving the burst."""
    from kueue_tpu_torch.controller.driver import Driver
    from kueue_tpu_torch.ops.burst import BurstSolver
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            Driver(device="cuda").schedule_burst(4)
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            BurstSolver(device="cuda")
    else:
        assert BurstSolver(device="cuda").device.type == "cuda"
    from kueue_tpu_torch.api import types as t
    d = Driver(device="cpu")
    d.apply_resource_flavor(t.ResourceFlavor(name="default"))
    d.apply_cluster_queue(t.ClusterQueue(
        name="cq", resource_groups=[t.ResourceGroup(
            covered_resources=["cpu"],
            flavors=[t.FlavorQuotas(name="default", resources={
                "cpu": t.ResourceQuota(nominal=1000)})])]))
    # nothing to schedule: one empty cycle, then quiescent
    assert [s.admitted for s in d.schedule_burst(2)] == [[]]
    assert d._burst_solver.device.type == "cpu"
    with pytest.raises(ValueError, match="Driver's"):
        d.schedule_burst(2, backend="accel")
    assert len(d.schedule_burst(1, backend="cpu")) == 1


def test_fs_kernels_run_plain_on_cpu_tensors():
    """fs_admit_scan and drs_components on CPU tensors run their plain
    versions and launch nothing; their launchers refuse CPU tensors."""
    import numpy as np
    from kueue_tpu_torch import kernels, testing
    from kueue_tpu_torch.ops import fairsharing_kernel, fs_scan
    before = dict(kernels.LAUNCHES)
    c = testing.fs_floor_case()
    args = [torch.from_numpy(a) for a in testing.fs_args(c)]
    kw = dict(depth=c["depth"], n_levels=c["n_levels"])
    order, admitted, processed = fs_scan.fs_admit_scan(*args, **kw)
    assert order.dtype == torch.int32 and admitted.dtype == torch.bool
    d_args, d_kw = testing.drs_case(np.random.default_rng(0), n_cqs=4,
                                    n_cohorts=2, depth=2, F=2, R=1,
                                    wl_req=False)
    b, lend = fairsharing_kernel.drs_components(
        *[torch.from_numpy(a) for a in d_args], **d_kw)
    assert b.dtype == lend.dtype == torch.int32
    assert kernels.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.fs_admit_scan(*args, **kw)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.drs_components(*[torch.from_numpy(a) for a in d_args],
                               **d_kw)


def test_tas_kernels_run_plain_on_cpu_tensors():
    """fill_counts, best_fit_descend and split_across_roots on CPU
    tensors run their plain versions and launch nothing; their launchers
    refuse CPU tensors."""
    from kueue_tpu_torch import kernels, testing
    from kueue_tpu_torch.ops import tas_kernel
    before = dict(kernels.LAUNCHES)
    leaf_free, per_pod, parents, sizes = testing.tas_wrap_case()
    args = [torch.from_numpy(leaf_free), torch.from_numpy(per_pod),
            tuple(torch.from_numpy(p) for p in parents)]
    states = tas_kernel.fill_counts(*args, level_sizes=sizes)
    assert [s.dtype for s in states] == [torch.int32] * 2
    ok, counts = tas_kernel.best_fit_descend(*args, 3, level_sizes=sizes,
                                             level=0)
    assert ok.dtype == torch.bool and counts.dtype == torch.int32
    ok, counts = tas_kernel.split_across_roots(*args, 3, level_sizes=sizes)
    assert ok.dtype == torch.bool and counts.dtype == torch.int32
    assert kernels.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.split_across_roots(*args, 3, level_sizes=sizes)


def test_tas_drain_in_a_fresh_process():
    """A small tas-4k run on "cpu" with the TAS gates on takes the
    device path's branches (no scalar walk) and loads neither jax nor
    kueue_tpu."""
    code = (
        "import sys\n"
        "from kueue_tpu_torch import scenarios\n"
        "with scenarios.tas_gates():\n"
        "    d, c, rt = scenarios.build_tas(device='cpu', blocks=2,\n"
        "        subblocks=2, hosts=4, n_cqs=4, n_cohorts=2, per_cq=8)\n"
        "    with scenarios.TASBranches() as br:\n"
        "        r = scenarios.run_tas(d, c, rt, cycles=8)\n"
        "assert r['admitted'] > 0, r\n"
        "assert br.counts['best_fit_descend'] > 0, br.counts\n"
        "assert br.counts['scalar_walk'] == 0, br.counts\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'kueue_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


class _FakePod:
    def __init__(self, name, pod_set="main"):
        self.name = name
        self.pod_set = pod_set
        self.annotations = {}
        self.node_selector = {}
        self.scheduling_gates = []
        self.phase = "Pending"


def test_port_ungater_rank_ordered_assignment():
    """tests/test_tas_kernel.py's ungater test on the port's copy."""
    from kueue_tpu_torch.api.types import (TopologyAssignment,
                                           TopologyDomainAssignment)
    from kueue_tpu_torch.controller.tas_ungater import (
        TAS_SCHEDULING_GATE, assign_pods_to_domains)
    ta = TopologyAssignment(
        levels=["block", "rack"],
        domains=[TopologyDomainAssignment(values=["b0", "r0"], count=2),
                 TopologyDomainAssignment(values=["b0", "r1"], count=1)])
    pods = [_FakePod("w-2"), _FakePod("w-0"), _FakePod("w-1")]
    for p in pods:
        p.scheduling_gates = [TAS_SCHEDULING_GATE]
    decisions = assign_pods_to_domains(ta, pods)
    assert [(d.pod_name, d.rank) for d in decisions] == [
        ("w-0", 0), ("w-1", 1), ("w-2", 2)]
    assert decisions[0].node_selector == {"block": "b0", "rack": "r0"}
    assert decisions[1].node_selector == {"block": "b0", "rack": "r0"}
    assert decisions[2].node_selector == {"block": "b0", "rack": "r1"}


def test_port_ungater_excess_pods_stay_gated():
    from kueue_tpu_torch.api.types import (TopologyAssignment,
                                           TopologyDomainAssignment)
    from kueue_tpu_torch.controller.tas_ungater import (
        TAS_SCHEDULING_GATE, assign_pods_to_domains)
    ta = TopologyAssignment(
        levels=["host"],
        domains=[TopologyDomainAssignment(values=["h0"], count=1)])
    pods = [_FakePod("p-0"), _FakePod("p-1")]
    for p in pods:
        p.scheduling_gates = [TAS_SCHEDULING_GATE]
    decisions = assign_pods_to_domains(ta, pods)
    assert len(decisions) == 1
    assert decisions[0].pod_name == "p-0"
