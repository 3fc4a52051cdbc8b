"""kueue_tpu_torch stands alone: it imports neither JAX nor anything of
kueue_tpu, its host-plane modules are the JAX package's files byte for
byte (except the listed ones), and its Driver runs on the card by
default — raising, never falling back, when there is none."""

import ast
import json
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
    "podset.py",
    "jobframework/__init__.py", "jobframework/interface.py",
    "jobframework/reconciler.py", "jobframework/webhook.py",
    "jobs/__init__.py", "jobs/base.py", "jobs/batch_job.py", "jobs/pod.py",
    "jobs/jobset.py", "jobs/kubeflow.py", "jobs/ray.py",
    "jobs/appwrapper.py", "jobs/serving.py",
    "config/__init__.py", "config/configuration.py",
    "api/manifests.py", "utils/expectations.py", "perf/__init__.py",
    "admissionchecks/provisioning.py",
    "traffic/__init__.py", "traffic/arrivals.py", "traffic/runner.py",
    "admissionchecks/__init__.py",
    "serving/__init__.py", "serving/ingest.py", "serving/service.py",
    "remote.py", "visibility.py", "federation/__init__.py",
    "dist/__init__.py", "dist/proxy.py",
    "leaderelection.py", "debugger.py",
)
# copies that begin with the original file and only append to it
APPENDED = ("ops/packing.py",)
# copies edited where they reached JAX or ops/ (CHANGES.md lists each)
EDITED = ("controller/driver.py", "ops/preemption_solver.py", "ops/burst.py",
          "cache/tas_snapshot.py", "cache/tas_cache.py", "perf/harness.py",
          "federation/sim.py", "federation/procs.py", "dist/serving.py",
          "dist/worker.py", "dist/supervisor.py", "dist/child.py",
          "admissionchecks/multikueue.py", "cli.py",
          "analysis/__init__.py", "analysis/core.py", "analysis/purity.py",
          "analysis/dtypes.py", "analysis/chaos_sites.py",
          "analysis/env_flags.py", "analysis/metrics_doc.py",
          "analysis/wal_order.py")


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


def test_native_core_is_the_jax_packages_file():
    """The C++ cycle core is carried over byte for byte."""
    rel = "native/cycle_core.cpp"
    assert _read(os.path.join(PORT, rel)) == _read(
        os.path.join(ROOT, "kueue_tpu", rel))


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
           "testing.py", "parallel/__init__.py", "parallel/sharded.py",
           "probe.py", "northstar.py", "native/__init__.py",
           "analysis/__main__.py", "chaos_soak.py", "obs_soak.py",
           "scale_soak.py", "perf/validate.py", "traffic_soak.py",
           "serve_soak.py", "federation_soak.py", "dist_soak.py",
           "accel_roofline.py", "compilecache.py", "ops/rtt.py"}
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


def test_no_import_by_name():
    """No module of the port imports by a name built at run time
    (``importlib``, ``__import__``), which the AST scan above could not
    see: every import of the port is a statement."""
    bad = []
    for path in _port_files():
        tree = ast.parse(_read(path), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            elif isinstance(node, ast.Name):
                names = [node.id]
            else:
                continue
            for n in names:
                if n.split(".")[0] in ("importlib", "__import__"):
                    bad.append((os.path.relpath(path, ROOT), n))
    assert not bad, bad


def _names_the_jax_package(text: str) -> bool:
    return text == "kueue_tpu" or text.startswith("kueue_tpu.")


def test_no_string_names_a_jax_package_module():
    """No string constant of the port is, or begins with, a module path
    of the JAX package (``"kueue_tpu"`` or ``"kueue_tpu.<...>"``): a
    child argv or a module looked up by such a string would load the
    JAX package, which the import scan above cannot see.  Docstrings
    that name a path inside prose do not begin with it."""
    bad = []
    for path in _port_files():
        tree = ast.parse(_read(path), filename=path)
        for node in ast.walk(tree):
            if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                    and _names_the_jax_package(node.value.strip())):
                bad.append((os.path.relpath(path, ROOT), node.lineno,
                            node.value))
    assert not bad, bad
    # the scan sees what it must: the JAX package's own child_argv
    src = _read(os.path.join(ROOT, "kueue_tpu", "dist", "supervisor.py"))
    assert any(isinstance(n, ast.Constant) and isinstance(n.value, str)
               and _names_the_jax_package(n.value)
               for n in ast.walk(ast.parse(src)))


def test_serving_and_remote_modules_in_a_fresh_process():
    """Importing the serving front, the remote plane and the process
    entry points (``dist.child`` included) loads neither jax nor
    kueue_tpu, and ``child_argv`` names the port's child module."""
    code = (
        "import sys\n"
        "import kueue_tpu_torch.dist.child, kueue_tpu_torch.serving\n"
        "import kueue_tpu_torch.federation, kueue_tpu_torch.remote\n"
        "import kueue_tpu_torch.visibility, kueue_tpu_torch.dist.supervisor\n"
        "import kueue_tpu_torch.federation.procs, kueue_tpu_torch.dist.proxy\n"
        "import kueue_tpu_torch.admissionchecks\n"
        "from kueue_tpu_torch.dist.supervisor import child_argv\n"
        "assert child_argv('shard')[2] == 'kueue_tpu_torch.dist.child'\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'kueue_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


@pytest.mark.parametrize("module,argv", [
    ("kueue_tpu_torch.cli", ["--help"]),
    ("kueue_tpu_torch.analysis", ["--json"]),
])
def test_cli_and_lint_in_a_fresh_process(module, argv):
    """``python -m kueue_tpu_torch.cli --help`` and ``python -m
    kueue_tpu_torch.analysis --json`` load neither jax nor kueue_tpu; the
    lint loads no torch and no numpy either."""
    code = (
        "import io, contextlib, runpy, sys\n"
        f"sys.argv = [{module!r}] + {argv!r}\n"
        "buf = io.StringIO()\n"
        "with contextlib.redirect_stdout(buf):\n"
        "    try:\n"
        f"        runpy.run_module({module!r}, run_name='__main__')\n"
        "    except SystemExit as e:\n"
        "        assert not e.code, (e.code, buf.getvalue()[-2000:])\n"
        "assert buf.getvalue(), 'no output'\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & "
        "{'jax', 'jaxlib', 'kueue_tpu', 'torch', 'numpy'}))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))
    assert not loaded & {"jax", "jaxlib", "kueue_tpu"}, loaded
    if module.endswith("analysis"):
        assert not loaded, loaded


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


def test_calibrated_warmup_in_a_fresh_process(tmp_path):
    """The router's warm-up (measure, persist, reload) and a cycle under
    the calibrated "auto" load neither jax nor kueue_tpu, and the
    sidecar lands in KUEUE_TPU_COMPILE_CACHE."""
    code = (
        "import sys\n"
        "from kueue_tpu_torch import compilecache, scenarios\n"
        "from kueue_tpu_torch.ops.solver import CycleSolver\n"
        "d, c, total, waves = scenarios.build_bench(0.01, device='cpu')\n"
        "s = d.scheduler.solver\n"
        "s.warmup(d.cache.snapshot(), 30)\n"
        "assert s.stats['native_calibration_failures'] == 0, s.stats\n"
        "again = CycleSolver(device='cpu')\n"
        "again.warmup(d.cache.snapshot(), 30)\n"
        "assert again.stats['calibration_loaded'] == 1, again.stats\n"
        "r = scenarios.run_bench(d, c, total, waves)\n"
        "assert r['finished'] == total, r\n"
        "assert compilecache.enable() == sys.argv[1]\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'kueue_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT,
               KUEUE_TPU_COMPILE_CACHE=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")
    assert [f for f in os.listdir(tmp_path) if f.startswith("calibration-")]


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
    """No path of the port raises as unported any more: under
    KUEUE_TPU_SHARDS=2 a CPU Driver (one device, no virtual mesh) builds,
    make_mesh finds fewer devices than asked and the per-cycle solver
    stays serial, as the JAX Driver does; ``set_mesh`` takes a mesh and
    None."""
    from kueue_tpu_torch.controller.driver import Driver
    from kueue_tpu_torch.parallel import sharded
    monkeypatch.setenv("KUEUE_TPU_SHARDS", "2")
    d = Driver(device="cpu")
    assert d.scheduler.solver.mesh is None
    assert sharded.make_mesh(2, device="cpu") is None
    mesh = sharded.make_mesh(1, device="cpu")
    d.scheduler.solver.set_mesh(mesh)
    assert d.scheduler.solver.mesh is mesh
    assert d.scheduler.solver.stats["sharded_dispatches"] == 0
    d.scheduler.solver.set_mesh(None)
    assert d.scheduler.solver.mesh is None


def test_every_kernel_source_is_built():
    """Each CUDA source and header beside the launchers is one that the
    build compiles (kernels.SOURCES) or includes (kernels.HEADERS), and
    each kernel counts its launches."""
    from kueue_tpu_torch import kernels
    kdir = os.path.join(PORT, "kernels")
    files = {f for f in os.listdir(kdir) if f.endswith((".cu", ".cuh"))}
    assert files == set(kernels.SOURCES) | set(kernels.HEADERS)
    assert set(kernels.LAUNCHES) == set(kernels.KERNELS)
    assert {"kq_scatter_rows", "kq_reduce_dflags", "kq_gather_heads",
            "kq_fs_merge_order"} <= set(kernels.KERNELS)
    assert "mesh_gather.cu" in kernels.SOURCES


def test_mesh_kernels_run_plain_on_cpu_tensors():
    """The head gather and the round merge on CPU tensors run their
    plain versions and launch nothing; their launchers refuse CPU
    tensors."""
    import numpy as np
    from kueue_tpu_torch import kernels, testing
    from kueue_tpu_torch.parallel import sharded
    before = dict(kernels.LAUNCHES)
    planes, head_of, fills = testing.gather_case(
        np.random.default_rng(0), W=12, S=3, n_valid=10)
    planes = tuple(tuple(torch.from_numpy(b) for b in p) for p in planes)
    head_of = tuple(torch.from_numpy(h) for h in head_of)
    src = torch.from_numpy(sharded.source_map(head_of, 12))
    out = sharded.gather_heads(planes, src, fills)
    assert [o.dtype for o in out] == [torch.bool, torch.int32]
    winners = tuple(torch.randperm(len(h), dtype=torch.int32)
                    for h in head_of)
    order = sharded.fs_merge_order(winners, head_of, 12)
    assert order.dtype == torch.int32
    assert sorted(order[:10].tolist()) == sorted(
        torch.cat(head_of).tolist())
    assert kernels.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.kq_gather_heads(planes, src, fills)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.kq_fs_merge_order(winners, head_of, 12)


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


def test_solve_cycle_runs_plain_on_cpu_tensors():
    """solve_cycle and solve_cycle_forests on CPU tensors run the plain
    versions and launch nothing; the three phase-1 launchers refuse CPU
    tensors."""
    import numpy as np
    from kueue_tpu_torch import kernels, scenarios, testing
    from kueue_tpu_torch.ops import cycle
    from kueue_tpu_torch.probe import probe_calls
    before = dict(kernels.LAUNCHES)
    for _, name, args, kw in probe_calls(64, 8, 4):
        out = getattr(cycle, name)(*[torch.from_numpy(a) for a in args],
                                   **kw)
        assert [o.dtype for o in out] == [torch.bool, torch.int32,
                                          torch.bool] * 2
    assert kernels.LAUNCHES == before
    for name, arrays, kw in testing.phase1_cases(testing.solve_cycle_planes(
            np.random.default_rng(0), W=16, n_valid=12)):
        with pytest.raises(ValueError, match="CUDA tensors"):
            getattr(kernels, name)(*[torch.from_numpy(a) for a in arrays],
                                   **kw)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            scenarios.entry()


def test_northstar_twin_in_a_fresh_process(tmp_path):
    """``python -m kueue_tpu_torch.northstar`` (the port's own twin of
    scripts/northstar_e2e.py) at ``--quick --torch-device cpu`` loads no
    jax, no kueue_tpu and no module of ``scripts``, and prints its JSON
    tail last; without a GPU and without ``--torch-device cpu`` it
    raises."""
    code = (
        "import json, runpy, sys\n"
        "import kueue_tpu_torch.northstar\n"
        "sys.argv = ['northstar', '--quick', '--device', '--cycles', '4',\n"
        "            '--torch-device', 'cpu']\n"
        "try:\n"
        "    runpy.run_module('kueue_tpu_torch.northstar', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert not e.code, e.code\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'kueue_tpu', 'scripts') or 'northstar_e2e' in m)\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    # the warm-up's router sidecar in the test's own directory
    env = dict(os.environ, PYTHONPATH=ROOT,
               KUEUE_TPU_COMPILE_CACHE=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == "ok"
    tail = json.loads(lines[-2])
    assert tail["metric"] == "northstar_e2e_cycle_p99"
    assert tail["device"]["cycles_run"] == 4
    # the solver measures kq_add_one's round trip only on a card
    assert "accel_rtt_ms" not in tail["device"]
    if not torch.cuda.is_available():
        out = subprocess.run(
            [sys.executable, "-m", "kueue_tpu_torch.northstar", "--quick"],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert "no CUDA GPU" in out.stderr
        assert not out.stdout.strip()


SOAK_TWINS = {
    "chaos_soak": (["--quick", "--only", "boundary_crash,shard_cascade_8_4_1"],
                   "chaos_soak_decision_parity"),
    "obs_soak": (["--cycles", "4", "--reps", "1"],
                 "obs_tracing_overhead_ratio"),
    "scale_soak": (["--quick", "--sizes", "16", "--ceiling-cqs", "32",
                    "--preempt-cohorts", "2", "--soak-workloads", "100",
                    "--rounds", "1", "--pool-rounds", "1"],
                   "active_cqs_at_ceiling_under_row_budget"),
    "traffic_soak": (["--quick", "--shards", "2"],
                     "open_loop_sustainable_admissions_per_s"),
    "serve_soak": (["--quick"], "serve_soak_wall_admissions_per_s"),
    "federation_soak": (["--quick", "--only", "worker_crash_mid_sync"],
                        "federation_soak_recovery_parity"),
    "dist_soak": (["--quick"], "dist_soak_saturation_admissions_per_s"),
    "accel_roofline": (["--quick"], "accel_roofline"),
}


@pytest.mark.parametrize("module", sorted(SOAK_TWINS))
def test_soak_twin_in_a_fresh_process(module, tmp_path):
    """``python -m kueue_tpu_torch.<chaos|obs|scale|traffic|serve|
    federation|dist>_soak`` and ``accel_roofline`` (the port's twins of
    scripts/*_soak.py and accel_roofline.py; traffic's sharded arm on a
    virtual mesh of 2; dist's children too) at a small size with
    ``--torch-device cpu`` load no jax, no kueue_tpu and no module of
    ``scripts``, print their JSON tail last and write no file where they
    run; without a GPU and without ``--torch-device cpu`` they raise
    before printing anything.  (The obs twin exits 1 when its overhead
    ratio passes 1.05, a timing gate not held here.)"""
    argv, metric = SOAK_TWINS[module]
    code = (
        "import runpy, sys\n"
        f"sys.argv = [{module!r}] + {argv!r} + ['--torch-device', 'cpu']\n"
        "try:\n"
        f"    runpy.run_module('kueue_tpu_torch.{module}', "
        "run_name='__main__')\n"
        "except SystemExit as e:\n"
        f"    assert not e.code or {module == 'obs_soak'}, e.code\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'kueue_tpu', 'scripts') or m.endswith('_soak')"
        " and not m.startswith('kueue_tpu_torch.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    # one torch thread, as the test workers have: the plain versions'
    # small ops gain nothing from more, and several twins run at once
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert os.listdir(tmp_path) == []
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == "ok"
    tail = json.loads(lines[-2])
    assert tail["metric"] == metric
    if module == "dist_soak":
        assert tail["all_ok"] is True
        assert tail["kills"]["service_mid_cycle"]["crash_exit"] == 17
    elif module == "accel_roofline":
        assert tail["accel_platform"] is None
        assert "crossover" not in tail and "tunnel" not in tail
    elif module == "chaos_soak":
        assert tail["scenarios_stable"] == tail["scenarios_total"] == 2
    elif module == "obs_soak":
        assert tail["decisions_identical"] is True
    elif module == "scale_soak":
        assert all(tail["parity"].values())
    elif module == "traffic_soak":
        assert tail["replay_identical"] is True
        assert tail["serial_shard_decisions_match"] is True
        assert tail["mesh"]["virtual"] is True
    elif module == "serve_soak":
        assert tail["parity"]["decisions_identical"] is True
        assert tail["kill_restart"]["digests_match"] is True
        assert tail["drain"]["clean"] is True
    else:
        assert tail["scenarios_stable"] == tail["scenarios_total"] == 1
    if not torch.cuda.is_available():
        out = subprocess.run(
            [sys.executable, "-m", f"kueue_tpu_torch.{module}"] + argv,
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert "no CUDA GPU" in out.stderr
        assert not out.stdout.strip()


def test_probe_in_a_fresh_process():
    """``python -m kueue_tpu_torch.probe`` with ``--device cpu`` at a tiny
    size loads neither jax nor kueue_tpu; without a GPU and without
    ``--device cpu`` it raises."""
    code = (
        "import runpy, sys\n"
        "sys.argv = ['probe', '64', '8', '--device', 'cpu', '--reps', '1']\n"
        "try:\n"
        "    runpy.run_module('kueue_tpu_torch.probe', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert not e.code, e.code\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'kueue_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "phase-1 classify 64x8" in out.stdout
    assert out.stdout.strip().endswith("ok")
    if not torch.cuda.is_available():
        out = subprocess.run(
            [sys.executable, "-m", "kueue_tpu_torch.probe", "64", "8"],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert "no CUDA GPU" in out.stderr
