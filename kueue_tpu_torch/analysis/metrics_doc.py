"""Metrics-doc registry: every emitted ``kueue_*`` series is documented.

The single source of truth is ``metrics._SERIES_DEFS`` (name, type,
labels, help) — the table ``Registry.render()`` uses for ``# HELP`` /
``# TYPE`` exposition.  This pass proves, statically, that the table
and reality cannot drift (mirroring the env-flags check):

- ``unregistered-series``   a full ``kueue_*`` string literal in
                            ``metrics.py`` or ``kueue_tpu_torch/obs/``
                            that names no registered series (a series
                            can be emitted only through a literal name,
                            so an undeclared emission is always visible
                            here)
- ``dynamic-series-name``   a ``"kueue_" + ...`` concatenation or
                            f-string in ``metrics.py`` — dynamic names
                            would blind this pass, so they are banned
                            outright (build a literal dict instead)
- ``readme-missing-series`` registered series absent from the README
                            "## Metrics" table
- ``readme-unknown-series`` README row naming an unregistered series
- ``readme-missing-table``  no "## Metrics" section at all
- ``registry-unparseable``  ``_SERIES_DEFS`` missing or not a literal
                            list of tuples
"""

from __future__ import annotations

import ast
import re

from .core import Context, Finding, ParsedFile

RULE = "metrics-doc"

_SERIES_RE = re.compile(r"^kueue_[a-z0-9_]+$")
_README_ROW_RE = re.compile(r"^\|\s*`(kueue_[a-z0-9_]+)`", re.MULTILINE)
_REGISTRY_FILE = "kueue_tpu_torch/metrics.py"
#: Files whose kueue_* literals must name registered series: the
#: registry implementation itself plus the obs plane (the only other
#: module that emits into the registry with literal series names).
_SCAN_PREFIXES = ("kueue_tpu_torch/metrics.py", "kueue_tpu_torch/obs/")


def _registry_names(pf: ParsedFile) -> tuple[set, Finding | None]:
    """Series names from the ``_SERIES_DEFS`` literal, or a finding."""
    for node in pf.index.of(ast.Assign):
        targets = [t.id for t in node.targets if isinstance(t, ast.Name)]
        if "_SERIES_DEFS" not in targets:
            continue
        if not isinstance(node.value, (ast.List, ast.Tuple)):
            break
        names = set()
        for el in node.value.elts:
            if (isinstance(el, ast.Tuple) and el.elts
                    and isinstance(el.elts[0], ast.Constant)
                    and isinstance(el.elts[0].value, str)):
                names.add(el.elts[0].value)
            else:
                return set(), Finding(
                    RULE, "registry-unparseable", pf.path, el.lineno, "",
                    "_SERIES_DEFS entry is not a literal tuple with a "
                    "string name first")
        return names, None
    return set(), Finding(
        RULE, "registry-unparseable", pf.path, 1, "",
        "metrics.py has no literal _SERIES_DEFS list")


def _dynamic_name(node: ast.AST):
    """lineno when this expression builds a kueue_* name dynamically."""
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        left = node.left
        if (isinstance(left, ast.Constant) and isinstance(left.value, str)
                and left.value.startswith("kueue_")):
            return node.lineno
    if isinstance(node, ast.JoinedStr):
        for part in node.values:
            if (isinstance(part, ast.Constant)
                    and isinstance(part.value, str)
                    and part.value.startswith("kueue_")):
                return node.lineno
    return None


def run(files: list[ParsedFile], ctx: Context) -> list[Finding]:
    out: list[Finding] = []
    registry_pf = next(
        (pf for pf in files if pf.path.endswith(_REGISTRY_FILE)), None)
    if registry_pf is None:
        src = ctx.text(_REGISTRY_FILE)
        if src is not None:
            registry_pf = ParsedFile.from_source(_REGISTRY_FILE, src)
    if registry_pf is None:
        return out  # nothing to check against (fixture run)
    registry, problem = _registry_names(registry_pf)
    if problem is not None:
        return [problem]

    for pf in files:
        if not pf.path.startswith(_SCAN_PREFIXES):
            continue
        for node in pf.index.of(ast.Constant, ast.BinOp, ast.JoinedStr):
            if (isinstance(node, ast.Constant)
                    and isinstance(node.value, str)
                    and _SERIES_RE.match(node.value)
                    and node.value not in registry):
                out.append(Finding(
                    RULE, "unregistered-series", pf.path, node.lineno,
                    node.value,
                    f"`{node.value}` is not declared in "
                    "metrics._SERIES_DEFS"))
            if pf.path.endswith(_REGISTRY_FILE):
                dyn = _dynamic_name(node)
                if dyn is not None:
                    out.append(Finding(
                        RULE, "dynamic-series-name", pf.path, dyn, "",
                        "series name built dynamically — use a literal "
                        "name (or a literal dict) so this pass can see "
                        "every emitted series"))

    readme = ctx.text("README.md")
    if readme is None:
        return out
    if "## Metrics" not in readme:
        out.append(Finding(RULE, "readme-missing-table", "README.md", 1,
                           "", "README has no \"## Metrics\" section"))
        return out
    documented = set(_README_ROW_RE.findall(readme))
    for name in sorted(registry - documented):
        out.append(Finding(RULE, "readme-missing-series", "README.md", 1,
                           name,
                           f"registered series `{name}` is missing from "
                           "the README metrics table"))
    for name in sorted(documented - registry):
        out.append(Finding(RULE, "readme-unknown-series", "README.md", 1,
                           name,
                           f"README documents `{name}` but it is not in "
                           "metrics._SERIES_DEFS"))
    return out
