"""WAL ordering: journal append dominates the store mutation.

The crash-consistency contract is *journal first, mutate
second*: recovery replays the WAL tail against the durable store, so a
mutation that precedes its append is lost on a crash between the two.
Chaos sites named ``wal.<op>`` exist precisely to crash in that window,
so they must sit *between* the append and the mutation.

The pass scans ``controller/driver.py``.  A function is WAL-scoped if
it journal-appends or hits a ``wal.*`` crashpoint; inside those:

- ``mutation-before-append``  a recognized store mutation precedes its
                              matching ``_journal.<op>_op`` append
- ``unjournaled-mutation``    a recognized mutation with no matching
                              append anywhere in the function
- ``chaos-outside-window``    a ``wal.<op>`` crashpoint not strictly
                              between the append and the mutation

Module-wide, every op kind that mutates somewhere must append
somewhere (``missing-journal-kind``) — this is what still fires when a
regression deletes both the append *and* the chaos point.

Functions like ``create_workload``/``restore_workload`` also write
``self.workloads`` but are repopulated from the durable store on
recovery, not from the WAL; they are out of scope by construction
(no append, no wal.* site).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

from .core import Context, Finding, ParsedFile, dotted

RULE = "wal-order"

_SCOPE_SUFFIX = "controller/driver.py"

#: op kind -> (journal encoder name, chaos site, mutation recognizer)
_KINDS = ("admit", "evict", "requeue", "finish", "deactivate")


def _mutation_kind(node: ast.AST):
    """(kind, lineno) if this statement is a recognized store mutation."""
    if isinstance(node, ast.Assign):
        for t in node.targets:
            if isinstance(t, ast.Subscript):
                d = dotted(t.value)
                if d and d.split(".")[-1] == "workloads":
                    return "admit", node.lineno
            if isinstance(t, ast.Attribute) and t.attr == "active":
                return "deactivate", node.lineno
    elif isinstance(node, ast.Call):
        d = dotted(node.func)
        tail = d.split(".")[-1] if d else None
        if tail == "set_evicted_condition":
            return "evict", node.lineno
        if tail == "set_finished_condition":
            return "finish", node.lineno
        if tail == "update_requeue_state":
            return "requeue", node.lineno
    return None


def _append_kind(index, node: ast.AST):
    """(kind, lineno) if this is ``*.log(_journal.<kind>_op(...))``."""
    if not (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "log"):
        return None
    for arg in index.walk(node):
        if isinstance(arg, ast.Call):
            d = dotted(arg.func)
            tail = d.split(".")[-1] if d else ""
            if tail.endswith("_op") and tail[:-3] in _KINDS:
                return tail[:-3], node.lineno
    return None


def _chaos_site(node: ast.AST):
    """(site, lineno) for ``*.crashpoint("wal.<op>")`` / ``.hit(...)``."""
    if (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in ("crashpoint", "hit")
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
            and node.args[0].value.startswith("wal.")):
        return node.args[0].value, node.lineno
    return None


@dataclass
class _FuncEvents:
    appends: dict = field(default_factory=dict)    # kind -> [lineno]
    chaos: dict = field(default_factory=dict)      # kind -> [lineno]
    mutations: dict = field(default_factory=dict)  # kind -> [lineno]


def _collect(index, node: ast.AST) -> _FuncEvents:
    ev = _FuncEvents()
    for n in index.walk(node):
        m = _mutation_kind(n)
        if m:
            ev.mutations.setdefault(m[0], []).append(m[1])
        a = _append_kind(index, n)
        if a:
            ev.appends.setdefault(a[0], []).append(a[1])
        c = _chaos_site(n)
        if c:
            kind = c[0].split(".", 1)[1]
            ev.chaos.setdefault(kind, []).append(c[1])
    return ev


def run(files: list[ParsedFile], ctx: Context) -> list[Finding]:
    out: list[Finding] = []
    for pf in files:
        if not pf.path.endswith(_SCOPE_SUFFIX):
            continue
        funcs = pf.index.functions()
        file_appends: set[str] = set()
        file_mutations: set[str] = set()

        for info in funcs.values():
            ev = _collect(pf.index, info.node)
            file_appends.update(ev.appends)
            file_mutations.update(ev.mutations)
            if not ev.appends and not ev.chaos:
                continue  # not WAL-scoped (store repopulation paths)

            def emit(code, line, msg):
                out.append(Finding(RULE, code, pf.path, line,
                                   info.qualname, msg))

            for kind, mlines in ev.mutations.items():
                alines = ev.appends.get(kind)
                if not alines:
                    emit("unjournaled-mutation", min(mlines),
                         f"`{kind}` mutation with no "
                         f"`_journal.{kind}_op` append in this function")
                    continue
                first_append = min(alines)
                for ml in mlines:
                    if ml < first_append:
                        emit("mutation-before-append", ml,
                             f"`{kind}` mutation at line {ml} precedes "
                             f"its journal append at line {first_append}"
                             "; a crash between them loses the op")
            for kind, clines in ev.chaos.items():
                alines = ev.appends.get(kind, [])
                mlines = ev.mutations.get(kind, [])
                for cl in clines:
                    before = [a for a in alines if a < cl]
                    after = [m for m in mlines if m > cl]
                    if not before:
                        emit("chaos-outside-window", cl,
                             f"`wal.{kind}` chaos point fires before the "
                             f"`{kind}` append — it would test nothing")
                    elif mlines and not after:
                        emit("chaos-outside-window", cl,
                             f"`wal.{kind}` chaos point fires after the "
                             f"`{kind}` mutation — the crash window it "
                             "models is append-done/mutation-pending")

        for kind in sorted(file_mutations - file_appends):
            out.append(Finding(
                RULE, "missing-journal-kind", pf.path, 1, "",
                f"`{kind}` mutations exist but no function appends "
                f"`_journal.{kind}_op` — the op kind is unjournaled"))
    return out
