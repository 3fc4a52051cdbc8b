"""The port's invariant lint (kueue_tpu_torch/analysis/), held to the JAX
package's (kueue_tpu/analysis/).

- **mapped fixtures** — every fixture of tests/test_static_analysis.py
  for the dtype, wal-order, chaos-sites and env-flags passes, its paths
  moved from ``kueue_tpu/`` to ``kueue_tpu_torch/`` (and its armed test
  file to ``tests/test_torch_*``): the port's pass makes the reference
  test's assertions and gives the JAX pass's findings, rule, code and
  line;
- **purity** has fixtures of its own, since the port has no jit: a
  seeded ``.item()`` in a launcher, ``time.time()`` in a plain twin, and
  a clean launcher whose first call builds the kernels;
- **dtype** reads torch creators and the launchers' ``_check`` calls;
- **the port's tree** has zero unsuppressed findings, no stale entry,
  a reason for every entry, a baseline smaller than the first full run,
  and ``python -m kueue_tpu_torch.analysis --json`` within the budget;
- **the shared node index** (``core.NodeIndex``, one walk a module)
  gives every pass the findings it gives when each query walks the tree
  again (``core.WalkIndex``), on the fixtures and on the port's tree.
"""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
import textwrap
import time

import pytest

from kueue_tpu.analysis import Context as RefContext
from kueue_tpu.analysis import ParsedFile as RefParsedFile
from kueue_tpu.analysis import chaos_sites as ref_chaos
from kueue_tpu.analysis import dtypes as ref_dtypes
from kueue_tpu.analysis import env_flags as ref_env
from kueue_tpu.analysis import wal_order as ref_wal
from kueue_tpu_torch.analysis import (
    BASELINE_PATH,
    Context,
    ParsedFile,
    apply_baseline,
    load_baseline,
    run_all,
)
from kueue_tpu_torch.analysis import (
    chaos_sites,
    core,
    dtypes,
    env_flags,
    metrics_doc,
    purity,
    wal_order,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def pf(path: str, src: str) -> ParsedFile:
    return ParsedFile.from_source(path, textwrap.dedent(src))


def codes(findings):
    return sorted({f.code for f in findings})


def port_path(path: str) -> str:
    if path.startswith("kueue_tpu/"):
        return "kueue_tpu_torch/" + path[len("kueue_tpu/"):]
    if path.startswith("tests/test_"):
        return "tests/test_torch_" + path[len("tests/test_"):]
    return path


def mapped(port_pass, ref_pass, tmp_path, files, extra=None, **kw):
    """Run the JAX pass on the fixture and the port's pass on it with its
    paths mapped; both must find the same (rule, code, line).  Returns
    the port's findings."""
    extra = {k: textwrap.dedent(v) for k, v in (extra or {}).items()}
    ref = ref_pass.run(
        [RefParsedFile.from_source(p, textwrap.dedent(s)) for p, s in files],
        RefContext(str(tmp_path), extra_sources=extra, **kw))
    port = port_pass.run(
        [pf(port_path(p), s) for p, s in files],
        Context(str(tmp_path), extra_sources={port_path(k): v
                                              for k, v in extra.items()},
                **kw))

    def key(fs):
        return sorted((f.rule, f.code, f.line) for f in fs)
    assert key(port) == key(ref)
    return port


# ---------------------------------------------------------------------------
# dtype fixtures (tests/test_static_analysis.py, mapped)
# ---------------------------------------------------------------------------

def test_dtype_flags_dtypeless_and_platform_creations(tmp_path):
    found = mapped(dtypes, ref_dtypes, tmp_path, [("kueue_tpu/ops/packing.py", """
        import numpy as np

        def build(n):
            a = np.zeros(n)
            b = np.arange(n)
            c = a.astype(int)
            return a, b, c
    """)])
    assert codes(found) == ["dtype-less", "platform-dtype"]
    assert sum(f.code == "dtype-less" for f in found) == 2


def test_dtype_flags_schema_mismatch_in_ensure_and_row_planes(tmp_path):
    found = mapped(dtypes, ref_dtypes, tmp_path, [(
        "kueue_tpu/ops/stream_pack.py", """
        import numpy as np

        _ROW_PLANES = {
            "wl_req": (0, np.int64, "R"),
            "mystery": (0, np.int32, None),
        }

        def views(arena, C, M):
            arena.ensure("wl_prio", (C, M), np.int16, 0)
            arena.ensure("u_cq0", (C, 4), np.int32, 0)
    """)])
    assert sum(f.code == "schema-mismatch" for f in found) == 2
    assert sum(f.code == "unknown-plane" for f in found) == 1


def test_dtype_accepts_clean_creations(tmp_path):
    found = mapped(dtypes, ref_dtypes, tmp_path, [("kueue_tpu/cache/arena.py", """
        import numpy as np

        def build(arena, n):
            a = np.zeros(n, dtype=np.int32)
            b = np.arange(n, dtype=np.int32)
            c = np.full((n,), -1, np.int16)
            arena.ensure("wl_req", (n, 4), np.int32, 0)
            return a, b, c
    """)])
    assert found == []


def test_dtype_flags_nonint32_tighten_plane(tmp_path):
    found = mapped(dtypes, ref_dtypes, tmp_path, [("kueue_tpu/ops/packing.py", """
        TIGHTEN_PLANES = ("wl_req", "vec_ok", "no_such_plane")
    """)])
    assert "schema-mismatch" in codes(found)
    assert "unknown-plane" in codes(found)


def test_schema_is_the_references():
    assert dtypes.PLANE_SCHEMA == ref_dtypes.PLANE_SCHEMA
    assert dtypes.TIGHTENABLE == ref_dtypes.TIGHTENABLE


# ---------------------------------------------------------------------------
# dtype: torch creators and the launchers' argument checks
# ---------------------------------------------------------------------------

_TORCH_CASES = """
    import torch

    I64 = torch.int64


    def launcher(t, n, dev):
        i32, b = torch.int32, torch.bool
        a = torch.zeros(n)
        c = torch.empty(n, dtype=i32, device=dev)
        d = torch.full((n,), -1, dtype=torch.int, device=dev)
        e = torch.tensor([1, 2])
        f = torch.as_tensor(t, torch.int64)
        g = torch.arange(n, dtype=int)
        h = torch.zeros_like(t)
        _check("parent", t, i32, (n,), dev)
        _check("parent", t, I64, (n,), dev)
        _check("vec_ok", t, b, (n,), dev)
        _check("vec_ok", t, i32, (n,), dev)
        _check("usage0", t, torch.int64, (n,), dev)
        _check("wl_req", t, torch.long, (n,), dev)

        def inner(u):
            i32 = torch.int64
            _check("nominal_cq", u, i32, (n,), dev)
            _check("slot_fr", u, torch.int32, (n,), dev)
        return a, c, d, e, f, g, h, inner
"""


def test_dtype_reads_torch_creators_and_checks(tmp_path):
    found = dtypes.run([pf("kueue_tpu_torch/kernels/__init__.py",
                           _TORCH_CASES)], Context(str(tmp_path)))
    got = sorted((f.line, f.code) for f in found)
    lines = textwrap.dedent(_TORCH_CASES).splitlines()

    def at(text):
        return next(i + 1 for i, ln in enumerate(lines) if text in ln)

    assert got == sorted([
        (at("a = torch.zeros(n)"), "dtype-less"),
        (at("e = torch.tensor"), "dtype-less"),
        (at("g = torch.arange"), "platform-dtype"),
        (at('_check("parent", t, I64'), "schema-mismatch"),
        (at('_check("vec_ok", t, i32'), "schema-mismatch"),
        (at('_check("wl_req", t, torch.long'), "schema-mismatch"),
        (at('_check("nominal_cq", u, i32'), "schema-mismatch"),
    ])
    msgs = {f.line: f.message for f in found}
    assert "plane `parent` as int64, schema says int32" in \
        msgs[at('_check("parent", t, I64')]
    assert "plane `vec_ok` as int32, schema says bool" in \
        msgs[at('_check("vec_ok", t, i32')]


def test_dtype_holds_the_launchers_checks_to_the_schema():
    """The real launchers' ``_check`` calls of registered planes ask for
    the schema's dtypes: the pass finds none that differs."""
    with open(os.path.join(ROOT, "kueue_tpu_torch", "kernels",
                           "__init__.py")) as fh:
        src = fh.read()
    tree = ast.parse(src)
    checked = {c.args[0].value for c in ast.walk(tree)
               if isinstance(c, ast.Call)
               and isinstance(c.func, ast.Name) and c.func.id == "_check"
               and isinstance(c.args[0], ast.Constant)
               and c.args[0].value in dtypes.PLANE_SCHEMA}
    assert {"parent", "nominal_cq", "wl_req"} <= checked
    found = dtypes.run([ParsedFile.from_source(
        "kueue_tpu_torch/kernels/__init__.py", src)], Context(ROOT))
    assert not [f for f in found if f.code == "schema-mismatch"]


# ---------------------------------------------------------------------------
# wal-order fixtures (mapped)
# ---------------------------------------------------------------------------

_WAL_CLEAN = """
    class Driver:
        def _apply_admission(self, wl):
            self._wal.log(_journal.admit_op(wl))
            _chaos.ACTIVE.crashpoint("wal.admit")
            self.workloads[wl.key] = wl

        def create_workload(self, wl):
            # store repopulation path: no journaling, out of scope
            self.workloads[wl.key] = wl
"""


def test_wal_accepts_append_chaos_mutation_order(tmp_path):
    assert mapped(wal_order, ref_wal, tmp_path, [
        ("kueue_tpu/controller/driver.py", _WAL_CLEAN)]) == []


def test_wal_flags_mutation_before_append(tmp_path):
    found = mapped(wal_order, ref_wal, tmp_path, [(
        "kueue_tpu/controller/driver.py", """
        class Driver:
            def _apply_admission(self, wl):
                self.workloads[wl.key] = wl
                self._wal.log(_journal.admit_op(wl))
    """)])
    assert codes(found) == ["mutation-before-append"]


def test_wal_flags_chaos_point_outside_window(tmp_path):
    found = mapped(wal_order, ref_wal, tmp_path, [(
        "kueue_tpu/controller/driver.py", """
        class Driver:
            def _evict(self, wl):
                self._wal.log(_journal.evict_op(wl.key))
                set_evicted_condition(wl, "r", "m", 0.0)
                _chaos.ACTIVE.crashpoint("wal.evict")
    """)])
    assert codes(found) == ["chaos-outside-window"]


def test_wal_flags_unjournaled_mutation_in_wal_scope(tmp_path):
    found = mapped(wal_order, ref_wal, tmp_path, [(
        "kueue_tpu/controller/driver.py", """
        class Driver:
            def finish(self, wl):
                self._wal.log(_journal.admit_op(wl))
                set_finished_condition(wl, "t", "m", 0.0)
    """)])
    assert "unjournaled-mutation" in codes(found)
    assert "missing-journal-kind" in codes(found)


def test_wal_flags_wholesale_journal_removal(tmp_path):
    found = mapped(wal_order, ref_wal, tmp_path, [(
        "kueue_tpu/controller/driver.py", """
        class Driver:
            def _evict(self, wl):
                set_evicted_condition(wl, "r", "m", 0.0)
    """)])
    assert codes(found) == ["missing-journal-kind"]


# ---------------------------------------------------------------------------
# chaos-sites fixtures (mapped; the armed file is a port test)
# ---------------------------------------------------------------------------

_INJECTOR_DOC = '''
    """Injector.

    ==============================  =====================
    site                            effect
    ==============================  =====================
    ``cycle.start``                 crash before a cycle
    ``wal.admit``                   crash mid-admit
    ==============================  =====================
    """
'''


def test_chaos_sites_clean_when_all_three_sets_agree(tmp_path):
    found = mapped(chaos_sites, ref_chaos, tmp_path, [
        ("kueue_tpu/chaos/injector.py", _INJECTOR_DOC),
        ("kueue_tpu/driver.py", """
            def f(inj):
                inj.crashpoint("cycle.start")
                inj.hit("wal.admit")
        """)], extra={"tests/test_x.py": """
        def test_y(inj):
            inj.arm("cycle.start", at=1)
            inj.arm("wal.admit", at=2)
    """})
    assert found == []


def test_chaos_sites_flags_every_kind_of_drift(tmp_path):
    found = mapped(chaos_sites, ref_chaos, tmp_path, [
        ("kueue_tpu/chaos/injector.py", _INJECTOR_DOC),
        ("kueue_tpu/driver.py", """
            def f(inj):
                inj.crashpoint("cycle.start")
                inj.crashpoint("secret.site")
        """)], extra={"tests/test_x.py": """
        def test_y(inj):
            inj.arm("cycle.start", at=1)
            inj.arm("tpyo.site", at=1)
    """})
    by = {f.code: f.symbol for f in found}
    assert by["undocumented-site"] == "secret.site"
    assert by["unthreaded-site"] == "wal.admit"
    assert by["unknown-armed-site"] == "tpyo.site"
    untested = {f.symbol for f in found if f.code == "untested-site"}
    assert untested == {"secret.site", "wal.admit"}


def test_chaos_sites_count_only_the_ports_tests_and_chip_smoke(tmp_path):
    """A site armed only by a JAX package test is untested in the port;
    one armed by chip_smoke.py is tested."""
    files = [pf("kueue_tpu_torch/chaos/injector.py", _INJECTOR_DOC),
             pf("kueue_tpu_torch/driver.py", """
                 def f(inj):
                     inj.crashpoint("cycle.start")
                     inj.hit("wal.admit")
             """)]
    arms = {"tests/test_chaos.py": textwrap.dedent("""
                def test_y(inj):
                    inj.arm("cycle.start", at=1)
                    inj.arm("wal.admit", at=2)
            """)}
    found = chaos_sites.run(files, Context(str(tmp_path),
                                           extra_sources=arms))
    assert {f.symbol for f in found if f.code == "untested-site"} == \
        {"cycle.start", "wal.admit"}
    arms["chip_smoke.py"] = "inj.arm('wal.admit', at=1)\n"
    arms["tests/test_torch_chaos.py"] = "inj.arm('cycle.start', at=1)\n"
    assert chaos_sites.run(files, Context(str(tmp_path),
                                          extra_sources=arms)) == []


# ---------------------------------------------------------------------------
# env-flags fixtures (mapped)
# ---------------------------------------------------------------------------

_FLAGS = {"KUEUE_TPU_FOO", "KUEUE_TPU_BAR"}
_README_OK = """
    ## Environment flags

    | flag | type | default | effect |
    |------|------|---------|--------|
    | `KUEUE_TPU_FOO` | bool | `1` | Foo. |
    | `KUEUE_TPU_BAR` | int | `0` | Bar. |
"""


def test_env_flags_clean_registry_reads(tmp_path):
    assert mapped(env_flags, ref_env, tmp_path, [("kueue_tpu/mod.py", """
        from .features import env_value

        def f():
            return env_value("KUEUE_TPU_FOO")
    """)], extra={"README.md": _README_OK}, env_flags=_FLAGS) == []


def test_env_flags_flags_adhoc_reads_and_unregistered_names(tmp_path):
    found = mapped(env_flags, ref_env, tmp_path, [("kueue_tpu/mod.py", """
        import os
        import os as _os

        def f():
            a = os.environ.get("KUEUE_TPU_FOO", "1")
            b = _os.environ.get("KUEUE_TPU_BAR", "0")
            c = os.environ["KUEUE_TPU_FOO"]
            d = os.getenv("KUEUE_TPU_FOO")
            e = "KUEUE_TPU_TYPO"
            # writes are allowed: harnesses configure children
            os.environ["KUEUE_TPU_FOO"] = "1"
            os.environ.setdefault("KUEUE_TPU_BAR", "0")
            return a, b, c, d, e
    """)], extra={"README.md": _README_OK}, env_flags=_FLAGS)
    assert sum(f.code == "ad-hoc-env-read" for f in found) == 4
    assert sum(f.code == "unregistered-flag" for f in found) == 1


def test_env_flags_checks_readme_table_both_ways(tmp_path):
    found = mapped(env_flags, ref_env, tmp_path, [], extra={"README.md": """
            ## Environment flags

            | `KUEUE_TPU_FOO` | bool | `1` | Foo. |
            | `KUEUE_TPU_GHOST` | int | `0` | Gone. |
        """}, env_flags=_FLAGS)
    by = {f.code: f.symbol for f in found}
    assert by["readme-missing-flag"] == "KUEUE_TPU_BAR"
    assert by["readme-unknown-flag"] == "KUEUE_TPU_GHOST"


def test_env_flags_flags_missing_readme_section(tmp_path):
    found = mapped(env_flags, ref_env, tmp_path, [],
                   extra={"README.md": "# nothing here\n"}, env_flags=_FLAGS)
    assert codes(found) == ["readme-missing-table"]


# ---------------------------------------------------------------------------
# purity: the port's launch paths
# ---------------------------------------------------------------------------

_LAUNCHERS = """
    import os
    import shutil
    import subprocess
    import time

    import torch

    LAUNCHES = {"admit_scan": 0}
    _lib = None


    def _nvcc():
        return shutil.which("nvcc") or os.environ.get("CUDA_HOME")


    def _run(cmd):
        subprocess.run(cmd, check=True)


    def build():
        t0 = time.perf_counter()
        _run([_nvcc(), "-c", "admit_scan.cu"])
        print("built in", time.perf_counter() - t0)


    def load():
        global _lib
        if _lib is None:
            build()
            _lib = object()
        return _lib


    def _launch(name, fn, *args):
        status = fn(*args, torch.cuda.current_stream().cuda_stream)
        if status != 0:
            raise RuntimeError(name)


    def admit_scan(x, depth):
        lib = load()
        n = int(x.shape[0]) + len(x.shape)
        out = torch.empty(n, dtype=torch.bool, device=x.device)
        _launch("admit_scan", lib.kq_admit_scan, x, out, depth)
        return out


    def host_report(t):
        return time.time(), t.item()
"""


def test_purity_accepts_a_clean_launcher_that_builds_at_first_call(tmp_path):
    """The first launch builds the library: nvcc found on the path, run
    in a subprocess, timed and printed — the walk stops at ``load`` and
    finds nothing; a host report that no launcher calls is out of
    scope."""
    files = [pf("kueue_tpu_torch/kernels/__init__.py", _LAUNCHERS)]
    assert purity.run(files, Context(str(tmp_path))) == []
    assert purity.launchers(files[0].tree) == {"admit_scan"}


def test_purity_flags_a_seeded_item_in_a_launcher(tmp_path):
    src = _LAUNCHERS.replace(
        "        n = int(x.shape[0]) + len(x.shape)\n",
        "        n = int(x.shape[0]) + len(x.shape)\n"
        "        w = x.sum().item()\n"
        "        LAUNCHES[\"admit_scan\"] += 1\n")
    found = purity.run([pf("kueue_tpu_torch/kernels/__init__.py", src)],
                       Context(str(tmp_path)))
    assert sorted((f.code, f.symbol) for f in found) == [
        ("global-mutation", "admit_scan"), ("traced-coercion", "admit_scan")]
    assert "device->host sync" in next(
        f.message for f in found if f.code == "traced-coercion")


def test_purity_flags_a_clock_in_a_plain_twin(tmp_path):
    files = [pf("kueue_tpu_torch/kernels/__init__.py", _LAUNCHERS),
             pf("kueue_tpu_torch/ops/cycle.py", """
        import time

        from .. import kernels


        def admit_scan(x, depth):
            if x.device.type == "cuda":
                return kernels.admit_scan(x, depth)
            return admit_scan_plain(x, depth)


        def admit_scan_plain(x, depth):
            t = time.time()
            return _walk(x, depth), t


        def _walk(x, depth):
            return [bool(v) for v in x.tolist()]


        def host_harness(x):
            t0 = time.time()
            print("host side may do this")
            return admit_scan(x, 1), time.time() - t0
    """)]
    found = purity.run(files, Context(str(tmp_path)))
    # one finding a line: the list's .tolist() and bool() share theirs
    assert sorted((f.code, f.symbol) for f in found) == [
        ("traced-coercion", "_walk"), ("wall-clock", "admit_scan_plain")]


def test_purity_counts_every_sync_and_host_effect(tmp_path):
    files = [pf("kueue_tpu_torch/kernels/__init__.py", _LAUNCHERS),
             pf("kueue_tpu_torch/parallel/fake.py", """
        import os
        import random

        import numpy as np

        from ..kernels import admit_scan

        _CACHE = {}


        def route(x, t):
            global _CACHE
            if os.environ.get("DEBUG"):
                print(x)
            a = x.cpu()
            b = x.numpy()
            c = float(t) + int(x.numel()) + int(x.dim())
            d = random.random() + np.random.rand()
            return admit_scan(x, 1), a, b, c, d, bool(x.any())
    """)]
    found = purity.run(files, Context(str(tmp_path)))
    got = sorted(f.code for f in found)
    assert got == sorted(["global-mutation", "host-io", "host-io",
                          "traced-coercion", "traced-coercion",
                          "traced-coercion", "traced-coercion",
                          "stdlib-random", "np-random"]), got


def test_purity_ignores_modules_without_launch_paths(tmp_path):
    files = [pf("kueue_tpu_torch/kernels/__init__.py", _LAUNCHERS),
             pf("kueue_tpu_torch/ops/hostonly.py", """
        import time

        def pure_host(x):
            return time.time() + x.item()
    """), pf("kueue_tpu_torch/scenarios.py", """
        from . import kernels

        def drive(x):
            return kernels.admit_scan(x, 1).item()
    """)]
    assert purity.run(files, Context(str(tmp_path))) == []


def test_purity_finds_the_real_launchers():
    with open(os.path.join(ROOT, "kueue_tpu_torch", "kernels",
                           "__init__.py")) as fh:
        tree = ast.parse(fh.read())
    found = purity.launchers(tree)
    assert {"admit_scan", "admit_scan_preempt", "admit_scan_forests",
            "minimal_preemptions_batch", "burst_cycles", "fs_admit_scan",
            "drs_components", "fill_counts", "best_fit_descend",
            "split_across_roots", "kq_cq_avail", "kq_classify_heads",
            "kq_cycle_order", "kq_scatter_rows", "kq_reduce_dflags",
            "kq_gather_heads", "kq_fs_merge_order"} <= found
    assert not found & set(purity.BUILD_STOPS)


# ---------------------------------------------------------------------------
# the port's tree is lint-clean, and the baseline only shrinks
# ---------------------------------------------------------------------------

def test_port_has_zero_unsuppressed_findings():
    findings = run_all(ROOT)
    baseline = load_baseline(BASELINE_PATH)
    unsuppressed, suppressed, stale = apply_baseline(findings, baseline)
    assert unsuppressed == [], "\n".join(f.render() for f in unsuppressed)
    assert stale == [], f"stale baseline entries (delete them): {stale}"


def test_baseline_only_shrinks_and_gives_its_reasons():
    baseline = load_baseline(BASELINE_PATH)
    first = baseline["first_full_run_findings"]
    assert first > 0
    assert len(baseline["entries"]) < first, \
        "grandfathering must shrink the finding count, not preserve it"
    for e in baseline["entries"]:
        assert e["reason"] and e["line"] > 0 and e["key"].count(":") >= 3, e
    assert BASELINE_PATH.startswith(os.path.join(ROOT, "kueue_tpu_torch"))


def test_cli_json_output_and_budget():
    proc = subprocess.run(
        [sys.executable, "-m", "kueue_tpu_torch.analysis", "--json"],
        capture_output=True, text=True, cwd=ROOT, timeout=60,
        env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr
    report = json.loads(proc.stdout)
    assert report["ok"] is True
    assert [p["name"] for p in report["passes"]] == [
        "purity", "dtype", "wal-order", "chaos-sites", "env-flags",
        "metrics-doc"]
    assert report["paths"] == ["kueue_tpu_torch", "chip_smoke.py",
                               "kernel_ab.py"]
    assert report["findings"] == [] and report["stale_baseline"] == []
    assert report["total_findings"] == report["baseline_entries"]
    assert report["elapsed_s"] < 10.0, "the lint must stay tier-1 fast"


# ---------------------------------------------------------------------------
# the shared node index against a walk at every query
# ---------------------------------------------------------------------------

_WAL_DRIFT = """
    class Driver:
        def _apply_admission(self, wl):
            self.workloads[wl.key] = wl
            self._wal.log(_journal.admit_op(wl))

        def _evict(self, wl):
            self._wal.log(_journal.evict_op(wl.key))
            set_evicted_condition(wl, "r", "m", 0.0)
            _chaos.ACTIVE.crashpoint("wal.evict")

        def finish(self, wl):
            set_finished_condition(wl, "t", "m", 0.0)
"""

_ENV_READS = """
    import os
    import os as _os

    def f():
        a = os.environ.get("KUEUE_TPU_FOO", "1")
        b = _os.environ.get("KUEUE_TPU_BAR", "0")
        c = os.environ["KUEUE_TPU_FOO"]
        d = os.getenv("KUEUE_TPU_FOO")
        e = "KUEUE_TPU_TYPO"
        os.environ["KUEUE_TPU_FOO"] = "1"
        return a, b, c, d, e
"""

_SYNCS = """
    import os
    import random
    import time

    import numpy as np

    from ..kernels import admit_scan

    _CACHE = {}


    def route(x, t):
        global _CACHE
        if os.environ.get("DEBUG"):
            print(x)
        a = x.cpu()
        c = float(t) + int(x.numel())
        d = random.random() + np.random.rand()
        return admit_scan(x, 1), a, c, d, bool(x.any())


    def admit_scan_plain(x, depth):
        def inner(v):
            return v.item(), time.time()
        return [inner(v) for v in x.tolist()]
"""

#: pass -> (module, files, extra sources, registered flags), the fixtures
#: above with findings of every code each pass has
_INDEX_CASES = {
    "purity": (purity, [
        ("kueue_tpu_torch/kernels/__init__.py", _LAUNCHERS.replace(
            "        n = int(x.shape[0]) + len(x.shape)\n",
            "        n = int(x.shape[0]) + len(x.shape)\n"
            "        w = x.sum().item()\n"
            "        LAUNCHES[\"admit_scan\"] += 1\n")),
        ("kueue_tpu_torch/parallel/fake.py", _SYNCS)], {}, None),
    "dtype": (dtypes, [
        ("kueue_tpu_torch/kernels/__init__.py", _TORCH_CASES),
        ("kueue_tpu_torch/ops/stream_pack.py", """
            import numpy as np

            _ROW_PLANES = {
                "wl_req": (0, np.int64, "R"),
                "mystery": (0, np.int32, None),
            }
            TIGHTEN_PLANES = ("wl_req", "vec_ok", "no_such_plane")

            def views(arena, C, M):
                a = np.zeros(C).astype(int)
                arena.ensure("wl_prio", (C, M), np.int16, 0)
                arena.ensure("u_cq0", (C, 4), np.int32, 0)
                return a
        """)], {}, None),
    "wal-order": (wal_order, [
        ("kueue_tpu_torch/controller/driver.py", _WAL_DRIFT)], {}, None),
    "chaos-sites": (chaos_sites, [
        ("kueue_tpu_torch/chaos/injector.py", _INJECTOR_DOC),
        ("kueue_tpu_torch/driver.py", """
            def f(inj):
                inj.crashpoint("cycle.start")
                inj.crashpoint("secret.site")
        """)], {"tests/test_torch_x.py": """
            def test_y(inj):
                inj.arm("cycle.start", at=1)
                inj.arm("tpyo.site", at=1)
        """}, None),
    "env-flags": (env_flags, [("kueue_tpu_torch/mod.py", _ENV_READS)],
                  {"README.md": """
            ## Environment flags

            | `KUEUE_TPU_FOO` | bool | `1` | Foo. |
            | `KUEUE_TPU_GHOST` | int | `0` | Gone. |
        """}, _FLAGS),
    "metrics-doc": (metrics_doc, [
        ("kueue_tpu_torch/metrics.py", """
            _SERIES_DEFS = [("kueue_a_total", "counter")]

            def emit(x):
                return "kueue_" + x, f"kueue_{x}_total", "kueue_b_total"
        """),
        ("kueue_tpu_torch/obs/spans.py", 'S = "kueue_c_seconds"\n')],
        {"README.md": "## Metrics\n\n| `kueue_ghost` | g |\n"}, None),
}


def _findings(case, tmp_path) -> list:
    mod, files, extra, flags = case
    ctx = Context(str(tmp_path), env_flags=flags, extra_sources={
        k: textwrap.dedent(v) for k, v in extra.items()})
    return [f.to_json() for f in mod.run([pf(p, s) for p, s in files], ctx)]


@pytest.mark.parametrize("name", sorted(_INDEX_CASES))
def test_pass_finds_the_same_with_and_without_the_index(
        monkeypatch, tmp_path, name):
    """Each pass over its fixtures: the same findings, in the same order,
    from the shared index as from a fresh walk at every query."""
    indexed = _findings(_INDEX_CASES[name], tmp_path)
    assert indexed and all(f["rule"] == name for f in indexed)
    monkeypatch.setattr(core, "INDEX", core.WalkIndex)
    assert _findings(_INDEX_CASES[name], tmp_path) == indexed


def test_node_index_answers_as_the_walk():
    """The index's nodes, parents, children, def walks and defs are the
    walk's, the shared operator and context singletons left out."""
    src = textwrap.dedent(_LAUNCHERS) + textwrap.dedent(_SYNCS) \
        + textwrap.dedent(_TORCH_CASES)
    tree = ast.parse(src)
    idx, ref = core.NodeIndex(tree), core.WalkIndex(tree)

    def kept(nodes):
        return [n for n in nodes if not isinstance(n, core._SINGLETONS)]

    assert idx.order == kept(ref.order)
    for types in ((ast.Call,), (ast.Import, ast.ImportFrom),
                  (ast.Call, ast.Subscript, ast.Constant)):
        assert idx.of(*types) == ref.of(*types)
    for node in idx.order[::7]:
        assert idx.parent(node) is ref.parent(node)
        assert list(idx.children(node)) == kept(ref.children(node))
    funcs, ref_funcs = idx.functions(), ref.functions()
    assert list(funcs) == list(ref_funcs) and "launcher.inner" in funcs
    for qn, info in funcs.items():
        assert info.node is ref_funcs[qn].node
        assert idx.walk(info.node) == kept(ref.walk(info.node))
    assert idx.parent(tree) is None


def test_the_ports_tree_with_and_without_the_index(monkeypatch, capsys):
    """The whole lint over the port: the same findings either way, each
    grandfathered; prints both walls (not asserted)."""
    t0 = time.perf_counter()
    indexed = run_all(ROOT)
    t1 = time.perf_counter()
    monkeypatch.setattr(core, "INDEX", core.WalkIndex)
    walked = run_all(ROOT)
    t2 = time.perf_counter()
    assert [f.to_json() for f in walked] == [f.to_json() for f in indexed]
    keys = {e["key"] for e in load_baseline(BASELINE_PATH)["entries"]}
    assert {f.key for f in indexed} == keys
    with capsys.disabled():
        print(f"\nlint over the port: {t1 - t0:.2f} s with the shared "
              f"index, {t2 - t1:.2f} s walking at every query")
