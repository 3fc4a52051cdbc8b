"""Kernel purity: no host effects, and no device-to-host sync, reachable
from a kernel launch path.

The port has no ``jax.jit`` and no ``shard_map``: its device kernels are
the hand-written CUDA kernels that ``kernels/__init__.py`` launches.
Scope is deliberately *not* "all of ops/": those modules mix launch
paths with host-side orchestration that legitimately reads clocks and
env vars.  The entries are

- every launcher: a def of ``kernels/__init__.py`` whose intra-module
  calls reach ``_launch`` (the one place a launch is made and counted),
  such as ``admit_scan``, ``burst_cycles`` and ``kq_scatter_rows``;
- every def of ``kernels/``, ``ops/`` and ``parallel/`` that calls a
  launcher (``kernels.<launcher>(...)``, or a launcher imported by
  name): the routers that send CUDA tensors to the kernel;
- every plain twin the kernels are held against: a def of that scope
  named ``*_plain``.

From them the pass walks the intra-module call graph, as the JAX
package's pass walks it from its traced entries, and holds only what
it reaches to purity.  The walk stops at the kernel build that the
first launch runs: ``load``, ``build``, ``_nvcc`` and ``_run`` (a
compiler found on the path and run in subprocesses, once a process),
which are neither entered nor checked.

- ``wall-clock``   calls through ``time``/``datetime``
- ``stdlib-random``calls through ``random`` (or names imported from it)
- ``np-random``    ``np.random.*`` (the unseeded global generator)
- ``traced-coercion`` a device-to-host sync in a launch path:
  ``.item()``, ``.tolist()``, ``.cpu()`` or ``.numpy()``, or
  ``float(x)`` / ``int(x)`` / ``bool(x)`` of a non-constant — the
  host waits for the card.  Metadata that lives on the host (``len``,
  ``.shape``, ``.numel()``, ``.dim()``, ``.size()``, ``.ndim``) is not
  a sync and is not flagged
- ``host-io``      ``open``/``print``/``input``, ``os.*`` calls
- ``global-mutation`` ``global`` statements, or stores through a
  module-level name (state shared by every launch, such as a counter)
"""

from __future__ import annotations

import ast

from .core import Context, Finding, FuncInfo, ParsedFile, dotted, index_of

RULE = "purity"

_SCOPE_PREFIXES = ("kueue_tpu_torch/kernels/", "kueue_tpu_torch/ops/",
                   "kueue_tpu_torch/parallel/")
_LAUNCHERS_FILE = "kueue_tpu_torch/kernels/__init__.py"
_LAUNCH = "_launch"
#: the kernel build at first use: the walk neither enters nor checks them
BUILD_STOPS = ("load", "build", "_nvcc", "_run")
#: calls whose value lives on the host (no sync when coerced)
_HOST_META = {"len", "numel", "dim", "size", "element_size", "stride",
              "data_ptr", "nelement"}
_HOST_META_ATTRS = {"shape", "ndim", "nbytes", "itemsize"}
_SYNC_METHODS = ("item", "tolist", "cpu", "numpy")


def _in_scope(path: str) -> bool:
    return path.startswith(_SCOPE_PREFIXES)


def _module_imports(index):
    """(module alias -> module name, from-imported name -> module)."""
    mod_alias: dict[str, str] = {}
    from_name: dict[str, str] = {}
    for node in index.of(ast.Import, ast.ImportFrom):
        if isinstance(node, ast.Import):
            for a in node.names:
                mod_alias[a.asname or a.name.split(".")[0]] = a.name
        elif isinstance(node, ast.ImportFrom):
            mod = "." * node.level + (node.module or "")
            for a in node.names:
                from_name[a.asname or a.name] = mod
    return mod_alias, from_name


def _simple_calls(index, node: ast.AST) -> set[str]:
    return {c.func.id for c in index.walk(node)
            if isinstance(c, ast.Call) and isinstance(c.func, ast.Name)}


def launchers(tree: ast.Module) -> set[str]:
    """Defs of the launchers' module whose intra-module calls reach
    ``_launch`` (the build stops excluded)."""
    index = index_of(tree)
    funcs = index.functions()
    calls = {qn.split(".")[-1]: set() for qn in funcs}
    for qn, info in funcs.items():
        calls[qn.split(".")[-1]] |= _simple_calls(index, info.node)
    reach = {_LAUNCH}
    changed = True
    while changed:
        changed = False
        for name, callees in calls.items():
            if name not in reach and name not in BUILD_STOPS \
                    and callees & reach:
                reach.add(name)
                changed = True
    return reach - {_LAUNCH}


def _calls_a_launcher(index, info: FuncInfo, wrappers: set[str],
                      mod_alias: dict[str, str],
                      from_name: dict[str, str]) -> bool:
    """True when the def calls ``kernels.<launcher>(...)`` or a launcher
    imported from the kernels module by name."""
    for c in index.walk(info.node):
        if not isinstance(c, ast.Call):
            continue
        d = dotted(c.func)
        if d is None:
            continue
        parts = d.split(".")
        if len(parts) == 2 and parts[1] in wrappers and (
                parts[0] == "kernels"
                or (mod_alias.get(parts[0], "").split(".")[-1]
                    == "kernels")):
            return True
        if len(parts) == 1 and parts[0] in wrappers \
                and from_name.get(parts[0], "").split(".")[-1] == "kernels":
            return True
    return False


def _entry_names(pf: ParsedFile, wrappers: set[str],
                 mod_alias: dict[str, str],
                 from_name: dict[str, str]) -> set[str]:
    """Simple names of the launch-path entries of one module."""
    roots: set[str] = set()
    funcs = pf.index.functions()
    is_launchers = pf.path.endswith(_LAUNCHERS_FILE)
    for qn, info in funcs.items():
        name = qn.split(".")[-1]
        if is_launchers and name in wrappers:
            roots.add(name)
        elif name.endswith("_plain"):
            roots.add(name)
        elif _calls_a_launcher(pf.index, info, wrappers, mod_alias,
                               from_name):
            roots.add(name)
    return roots


def _reachable(index, roots: set[str]) -> dict[str, FuncInfo]:
    """Launch-path scope: defs reachable from the entry names via
    simple-name calls within this module, short of the build stops."""
    funcs = index.functions()
    by_simple: dict[str, list[FuncInfo]] = {}
    for info in funcs.values():
        by_simple.setdefault(info.qualname.split(".")[-1], []).append(info)

    seen: dict[str, FuncInfo] = {}
    frontier = [r for r in roots if r not in BUILD_STOPS]
    while frontier:
        name = frontier.pop()
        for info in by_simple.get(name, []):
            if info.qualname in seen:
                continue
            seen[info.qualname] = info
            for callee in _simple_calls(index, info.node):
                if callee not in seen and callee not in BUILD_STOPS:
                    frontier.append(callee)
    return seen


def _module_level_names(tree: ast.Module) -> set[str]:
    names: set[str] = set()
    for node in tree.body:
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
            targets = [node.target]
        for t in targets:
            if isinstance(t, ast.Name):
                names.add(t.id)
    return names


def _host_value(node: ast.AST) -> bool:
    """True for an expression whose value lives on the host: a constant,
    ``len(...)``, shape metadata, or arithmetic of those."""
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.Call):
        f = node.func
        if isinstance(f, ast.Name) and f.id in _HOST_META:
            return True
        if isinstance(f, ast.Attribute) and f.attr in _HOST_META:
            return True
    if isinstance(node, ast.Attribute) and node.attr in _HOST_META_ATTRS:
        return True
    if isinstance(node, ast.Subscript):
        return _host_value(node.value)
    if isinstance(node, ast.BinOp):
        return _host_value(node.left) and _host_value(node.right)
    if isinstance(node, ast.UnaryOp):
        return _host_value(node.operand)
    return False


def _check_kernel(pf: ParsedFile, info: FuncInfo, mod_alias: dict[str, str],
                  from_name: dict[str, str], module_names: set[str],
                  out: list[Finding]):
    clock_mods = {a for a, m in mod_alias.items()
                  if m in ("time", "datetime")}
    rand_mods = {a for a, m in mod_alias.items() if m == "random"}
    rand_names = {n for n, m in from_name.items() if m == "random"}
    clock_names = {n for n, m in from_name.items()
                   if m in ("time", "datetime")}
    os_mods = {a for a, m in mod_alias.items() if m == "os"}
    np_mods = {a for a, m in mod_alias.items() if m == "numpy"}

    def emit(code: str, node: ast.AST, msg: str):
        out.append(Finding(RULE, code, pf.path, node.lineno,
                           info.qualname, msg))

    nodes = pf.index.walk(info.node)
    # locals of this def shadow module globals for the mutation check
    local_names = {a.arg for a in nodes if isinstance(a, ast.arg)}
    for n in nodes:
        if isinstance(n, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            ts = n.targets if isinstance(n, ast.Assign) else [n.target]
            for t in ts:
                if isinstance(t, ast.Name):
                    local_names.add(t.id)

    for node in nodes:
        if isinstance(node, ast.Global):
            emit("global-mutation", node,
                 f"`global {', '.join(node.names)}` in a launch path "
                 "mutates module state")
        elif isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                base = t
                while isinstance(base, (ast.Subscript, ast.Attribute)):
                    base = base.value
                if (isinstance(base, ast.Name) and base.id in module_names
                        and base.id not in local_names):
                    emit("global-mutation", node,
                         f"store through module-level `{base.id}` from a "
                         "launch path")
        elif isinstance(node, ast.Call):
            d = dotted(node.func)
            root = d.split(".")[0] if d else None
            if root in clock_mods or d in clock_names:
                emit("wall-clock", node,
                     f"wall-clock call `{d}()` in a launch path")
            elif (root in rand_mods or d in rand_names):
                emit("stdlib-random", node,
                     f"stdlib random call `{d}()` in a launch path")
            elif (d and root in np_mods
                  and d.split(".")[1:2] == ["random"]):
                emit("np-random", node,
                     f"unseeded `{d}()` in a launch path")
            elif root in os_mods:
                emit("host-io", node,
                     f"host call `{d}()` in a launch path")
            elif isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _SYNC_METHODS and not node.args:
                emit("traced-coercion", node,
                     f"`.{node.func.attr}()` forces a device->host sync "
                     "of a tensor in a launch path")
            elif (isinstance(node.func, ast.Name)
                  and node.func.id in ("float", "int", "bool")
                  and node.args
                  and not _host_value(node.args[0])):
                emit("traced-coercion", node,
                     f"`{node.func.id}()` coercion of a (potentially "
                     "device) value in a launch path")
            elif (isinstance(node.func, ast.Name)
                  and node.func.id in ("open", "print", "input")):
                emit("host-io", node,
                     f"`{node.func.id}()` in a launch path")


def run(files: list[ParsedFile], ctx: Context) -> list[Finding]:
    out: list[Finding] = []
    launch_file = next((pf for pf in files
                        if pf.path.endswith(_LAUNCHERS_FILE)), None)
    wrappers = launchers(launch_file.tree) if launch_file else set()
    for pf in files:
        if not _in_scope(pf.path):
            continue
        mod_alias, from_name = _module_imports(pf.index)
        roots = _entry_names(pf, wrappers, mod_alias, from_name)
        if not roots:
            continue
        module_names = _module_level_names(pf.tree)
        for info in _reachable(pf.index, roots).values():
            _check_kernel(pf, info, mod_alias, from_name, module_names, out)
    # a nested def reachable both via its parent's subtree and by name
    # would double-report: keep the first finding per site
    seen: set[tuple] = set()
    deduped = []
    for f in out:
        site = (f.code, f.path, f.line)
        if site not in seen:
            seen.add(site)
            deduped.append(f)
    return deduped
