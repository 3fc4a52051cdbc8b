"""Findings, file collection, pass protocol, baseline and runner.

Design notes:

- A :class:`Finding`'s baseline key deliberately excludes the line
  number — grandfathered entries survive unrelated edits to the same
  file and go stale only when the underlying violation moves or dies.
- A baseline entry suppresses *every* finding with its key (the key
  includes rule, code, file and enclosing symbol, so collisions mean
  "the same kind of violation in the same function" — close enough to
  one decision).  Stale entries (no matching finding) are themselves
  an error: the baseline may only shrink.
- Nothing in this package imports torch, numpy or jax.  Passes that
  reason about dtypes do it over strings; the whole suite must stay
  cheap enough to run as a tier-1 test.
- The default scan is the port: ``kueue_tpu_torch/``, ``chip_smoke.py``
  and ``kernel_ab.py`` (``DEFAULT_PATHS``).
- Each parsed module is walked once, at parse time, into a
  :class:`NodeIndex` (its nodes by type, each node's parent and
  children, each def's own nodes) that every pass reads instead of
  walking the tree again.  :class:`WalkIndex` answers the same queries
  by walking the tree each time: the plain version the index is held
  against (``tests/test_torch_analysis.py``).
"""

from __future__ import annotations

import ast
import gc
import json
import os
from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional

BASELINE_PATH = os.path.join(os.path.dirname(__file__), "baseline.json")

#: What ``run_all`` and ``python -m kueue_tpu_torch.analysis`` scan by
#: default, relative to the repository root.
DEFAULT_PATHS = ("kueue_tpu_torch", "chip_smoke.py", "kernel_ab.py")

#: Directory basenames never worth parsing.
_SKIP_DIRS = {"__pycache__", ".git", ".venv", "node_modules", ".pytest_cache"}


@dataclass(frozen=True)
class Finding:
    rule: str       # pass name, e.g. "wal-order"
    code: str       # check within the pass, e.g. "mutation-before-append"
    path: str       # repo-relative posix path
    line: int
    symbol: str     # enclosing function qualname ("" = module level)
    message: str

    @property
    def key(self) -> str:
        return f"{self.rule}:{self.code}:{self.path}:{self.symbol}"

    def render(self) -> str:
        where = f"{self.path}:{self.line}"
        sym = f" [{self.symbol}]" if self.symbol else ""
        return f"{where}: {self.rule}/{self.code}{sym}: {self.message}"

    def to_json(self) -> dict:
        return {"rule": self.rule, "code": self.code, "path": self.path,
                "line": self.line, "symbol": self.symbol,
                "message": self.message, "key": self.key}


class NodeIndex:
    """One walk of a module's tree, shared by the passes.

    ``order`` holds its nodes in ``ast.walk`` order, all but the shared
    operator and expression-context singletons (``Load``, ``Add``, ...),
    which no pass asks for; ``of(*types)`` the nodes of those types in
    that order; ``parent`` / ``children`` each node's; ``walk(node)`` a
    subtree's nodes in that order (a def's own nodes, kept once asked
    for); ``functions()`` the module's defs as :func:`index_functions`
    gives them; ``memo`` a pass's per-module results."""

    def __init__(self, tree: ast.AST):
        order = [tree]
        children: dict = {}
        by_type: dict = {}
        node_t, leaves, skip, empty = ast.AST, _LEAVES, _SINGLETONS, ()
        for node in order:           # the list grows as the walk goes
            t = type(node)
            nodes = by_type.get(t)
            if nodes is None:
                nodes = by_type[t] = []
            nodes.append(node)
            if t in leaves:
                children[node] = empty
                continue
            kids = []
            # a parsed node's __dict__ holds its _fields in order, then
            # its position attributes (ints)
            for v in node.__dict__.values():
                if type(v) is list:
                    if v:
                        kids += [x for x in v if isinstance(x, node_t)
                                 and not isinstance(x, skip)]
                elif isinstance(v, node_t) and not isinstance(v, skip):
                    kids.append(v)
            children[node] = kids
            if kids:
                order += kids
        self.tree = tree
        self.order = order
        self._children = children
        self._by_type = by_type
        self._parent: Optional[dict] = None
        self._walks: dict = {}
        self._functions: Optional[dict] = None
        self.memo: dict = {}

    def of(self, *types) -> list:
        if len(types) == 1:
            return self._by_type.get(types[0], [])
        ts = set(types)
        return [n for n in self.order if type(n) in ts]

    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        if self._parent is None:
            self._parent = {k: n for n, kids in self._children.items()
                            for k in kids}
        return self._parent.get(node)

    def children(self, node: ast.AST) -> list:
        return self._children[node]

    def walk(self, node: ast.AST) -> list:
        out = self._walks.get(node)
        if out is None:
            out = [node]
            i = 0
            while i < len(out):
                out.extend(self._children[out[i]])
                i += 1
            self._walks[node] = out
        return out

    def functions(self) -> dict:
        if self._functions is None:
            self._functions = _functions(self.tree, self.children, True)
        return self._functions


#: shared singletons of the parsed tree, never indexed
_SINGLETONS = (ast.expr_context, ast.boolop, ast.operator, ast.unaryop,
               ast.cmpop)
#: node types with no child but those singletons
_LEAVES = frozenset((ast.Name, ast.Constant, ast.Pass, ast.Break,
                     ast.Continue, ast.alias))


class WalkIndex:
    """:class:`NodeIndex`'s queries answered by walking the tree again
    at every call (no node, walk or memo is shared)."""

    def __init__(self, tree: ast.AST):
        self.tree = tree

    @property
    def order(self) -> list:
        return list(ast.walk(self.tree))

    @property
    def memo(self) -> dict:
        return {}

    def of(self, *types) -> list:
        return [n for n in ast.walk(self.tree) if isinstance(n, types)]

    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        for p in ast.walk(self.tree):
            if any(c is node for c in ast.iter_child_nodes(p)):
                return p
        return None

    def children(self, node: ast.AST) -> list:
        return list(ast.iter_child_nodes(node))

    def walk(self, node: ast.AST) -> list:
        return list(ast.walk(node))

    def functions(self) -> dict:
        return _functions(self.tree, self.children, False)


#: the index ``index_of`` builds (``WalkIndex`` walks at every query)
INDEX = NodeIndex


def index_of(tree: ast.AST):
    """The module's index, built on first use and kept on the tree."""
    idx = tree.__dict__.get("_node_index")
    if type(idx) is not INDEX:
        idx = INDEX(tree)
        tree._node_index = idx
    return idx


@dataclass
class ParsedFile:
    path: str                    # repo-relative posix path
    source: str
    tree: ast.Module

    @classmethod
    def from_source(cls, path: str, source: str) -> "ParsedFile":
        pf = cls(path=path, source=source,
                 tree=ast.parse(source, filename=path))
        index_of(pf.tree)
        return pf

    @property
    def index(self):
        return index_of(self.tree)


class Context:
    """What a pass may see beyond the scanned file list.

    ``extra_sources`` (path -> source text) shadows the filesystem so
    fixture tests can feed synthetic READMEs / test files; ``env_flags``
    likewise overrides the live registry."""

    def __init__(self, root: str, extra_sources: Optional[dict] = None,
                 env_flags: Optional[dict] = None):
        self.root = root
        self.extra_sources = dict(extra_sources or {})
        self.env_flags = env_flags

    def text(self, relpath: str) -> Optional[str]:
        if relpath in self.extra_sources:
            return self.extra_sources[relpath]
        full = os.path.join(self.root, relpath)
        if not os.path.isfile(full):
            return None
        with open(full, encoding="utf-8") as fh:
            return fh.read()

    def parse_dir(self, reldir: str, name_prefix: str = ""
                  ) -> list[ParsedFile]:
        """Parse ``reldir/<name_prefix>*.py`` (non-recursive), extras
        included."""
        out = []
        seen = set()
        prefix = reldir.rstrip("/") + "/" + name_prefix
        for path, src in self.extra_sources.items():
            if path.startswith(prefix) and path.endswith(".py"):
                out.append(ParsedFile.from_source(path, src))
                seen.add(path)
        full = os.path.join(self.root, reldir)
        if os.path.isdir(full):
            for name in sorted(os.listdir(full)):
                rel = reldir.rstrip("/") + "/" + name
                if name.endswith(".py") and rel.startswith(prefix) \
                        and rel not in seen:
                    text = self.text(rel)
                    if text is not None:
                        out.append(ParsedFile.from_source(rel, text))
        return out


@dataclass
class Pass:
    name: str
    doc: str
    run: Callable[[list[ParsedFile], Context], list[Finding]]


def collect_files(root: str, paths: Iterable[str]) -> list[ParsedFile]:
    """Parse every ``*.py`` under ``paths`` (files or directories,
    repo-relative to ``root``), sorted for determinism."""
    found: list[str] = []
    for p in paths:
        full = os.path.join(root, p)
        if os.path.isfile(full):
            found.append(p)
            continue
        for dirpath, dirnames, filenames in os.walk(full):
            dirnames[:] = sorted(d for d in dirnames if d not in _SKIP_DIRS)
            for name in sorted(filenames):
                if name.endswith(".py"):
                    rel = os.path.relpath(os.path.join(dirpath, name), root)
                    found.append(rel.replace(os.sep, "/"))
    out = []
    for rel in sorted(set(found)):
        with open(os.path.join(root, rel), encoding="utf-8") as fh:
            out.append(ParsedFile.from_source(rel, fh.read()))
    return out


def all_passes() -> list[Pass]:
    from . import (chaos_sites, dtypes, env_flags, metrics_doc, purity,
                   wal_order)
    return [
        Pass("purity", "no host effects or syncs reachable from the "
             "kernel launchers", purity.run),
        Pass("dtype", "plane creations match the declared schema",
             dtypes.run),
        Pass("wal-order", "journal append dominates the store mutation",
             wal_order.run),
        Pass("chaos-sites", "doc / code / scenario site sets agree",
             chaos_sites.run),
        Pass("env-flags", "KUEUE_TPU_* reads go through the registry",
             env_flags.run),
        Pass("metrics-doc", "every emitted kueue_* series is documented",
             metrics_doc.run),
    ]


def run_all(root: str, paths: Optional[Iterable[str]] = None,
            passes: Optional[list[Pass]] = None,
            ctx: Optional[Context] = None) -> list[Finding]:
    if paths is None:
        paths = DEFAULT_PATHS
    # every tree lives to the end of the run: collecting while they are
    # built would only rescan them
    collecting = gc.isenabled()
    gc.disable()
    try:
        files = collect_files(root, paths)
        ctx = ctx or Context(root)
        findings: list[Finding] = []
        for p in (passes if passes is not None else all_passes()):
            findings.extend(p.run(files, ctx))
    finally:
        if collecting:
            gc.enable()
    findings.sort(key=lambda f: (f.path, f.line, f.rule, f.code))
    return findings


# --------------------------------------------------------------------------
# Baseline
# --------------------------------------------------------------------------

def load_baseline(path: str = BASELINE_PATH) -> dict:
    if not os.path.isfile(path):
        return {"first_full_run_findings": 0, "entries": []}
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


def apply_baseline(findings: list[Finding], baseline: dict):
    """Split findings into (unsuppressed, suppressed) and report stale
    baseline entries (entries matching nothing — they must be deleted,
    which is how "the baseline only shrinks" is enforced)."""
    keys = {e["key"] if isinstance(e, dict) else e
            for e in baseline.get("entries", [])}
    unsuppressed = [f for f in findings if f.key not in keys]
    suppressed = [f for f in findings if f.key in keys]
    live = {f.key for f in suppressed}
    stale = sorted(keys - live)
    return unsuppressed, suppressed, stale


# --------------------------------------------------------------------------
# Small AST helpers shared by the passes
# --------------------------------------------------------------------------

def dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` -> "a.b.c" for Name/Attribute chains, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def str_const(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


@dataclass
class FuncInfo:
    qualname: str
    node: ast.AST            # FunctionDef | AsyncFunctionDef | Lambda
    parent: Optional[str] = None


#: the nodes a def or a class can stand in or under (defs are statements)
_STMT_HOLDERS = (ast.stmt, ast.excepthandler, ast.match_case)


def _functions(tree: ast.AST, children, stmts_only: bool
               ) -> dict[str, FuncInfo]:
    """qualname -> FuncInfo for every (nested) def, in source pre-order;
    ``stmts_only`` descends into statements only, where every def is."""
    out: dict[str, FuncInfo] = {}

    def walk(node: ast.AST, prefix: str):
        for child in children(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qn = f"{prefix}{child.name}" if prefix else child.name
                out[qn] = FuncInfo(qn, child, prefix.rstrip(".") or None)
                walk(child, qn + ".")
            elif isinstance(child, ast.ClassDef):
                walk(child, (prefix + child.name + ".") if prefix
                     else child.name + ".")
            elif not stmts_only or isinstance(child, _STMT_HOLDERS):
                walk(child, prefix)

    walk(tree, "")
    return out


def index_functions(tree: ast.Module) -> dict[str, FuncInfo]:
    """qualname -> FuncInfo for every (nested) def in the module."""
    return index_of(tree).functions()
