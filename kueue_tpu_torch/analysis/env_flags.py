"""Env-flag registry: every ``KUEUE_TPU_*`` read is declared.

The single source of truth is ``features.ENV_FLAGS`` (name, default,
type, doc).  Reads go through ``features.env_value``/``env_int``; the
README "Environment flags" table is generated from the same registry
and checked here, so docs cannot drift from code.

- ``ad-hoc-env-read``     ``os.environ.get/[...]``/``os.getenv`` of a
                          ``KUEUE_TPU_*`` name outside features.py
                          (writes — ``environ[...] = ``, ``setdefault``,
                          ``pop`` — are fine: harnesses configure
                          children through the environment)
- ``unregistered-flag``   a ``KUEUE_TPU_*`` string literal that names
                          no registered flag (typo or undeclared knob)
- ``readme-missing-flag`` registered flag absent from the README table
- ``readme-unknown-flag`` README row naming an unregistered flag
- ``readme-missing-table``no "## Environment flags" section at all
"""

from __future__ import annotations

import ast
import re

from .core import Context, Finding, ParsedFile, dotted

RULE = "env-flags"

_PREFIX = "KUEUE_TPU_"
_FLAG_RE = re.compile(r"^KUEUE_TPU_[A-Z0-9_]+$")
_README_ROW_RE = re.compile(r"^\|\s*`(KUEUE_TPU_[A-Z0-9_]+)`", re.MULTILINE)
_REGISTRY_FILE = "kueue_tpu_torch/features.py"


def _registry(ctx: Context) -> set[str]:
    if ctx.env_flags is not None:
        return set(ctx.env_flags)
    from ..features import ENV_FLAGS
    return set(ENV_FLAGS)


def _os_aliases(index) -> set[str]:
    """Names the ``os`` module is bound to in this file (``os``,
    ``import os as _os``, ...)."""
    out = {"os"}
    for node in index.of(ast.Import):
        for a in node.names:
            if a.name == "os":
                out.add(a.asname or "os")
    return out


def _env_read(node: ast.AST, os_names: set[str]):
    """lineno if this node reads the environment; the flag literal (or
    None for dynamic names) is returned alongside."""
    if isinstance(node, ast.Call):
        d = dotted(node.func)
        parts = d.split(".") if d else []
        is_get = (
            (len(parts) == 3 and parts[0] in os_names
             and parts[1:] == ["environ", "get"])
            or parts == ["environ", "get"]
            or (len(parts) == 2 and parts[0] in os_names
                and parts[1] == "getenv")
            or parts == ["getenv"])
        if is_get and node.args:
            a = node.args[0]
            lit = a.value if isinstance(a, ast.Constant) and \
                isinstance(a.value, str) else None
            return node.lineno, lit
    elif isinstance(node, ast.Subscript) and \
            isinstance(node.ctx, ast.Load):
        d = dotted(node.value)
        parts = d.split(".") if d else []
        if parts == ["environ"] or (len(parts) == 2
                                    and parts[0] in os_names
                                    and parts[1] == "environ"):
            s = node.slice
            lit = s.value if isinstance(s, ast.Constant) and \
                isinstance(s.value, str) else None
            return node.lineno, lit
    return None


def run(files: list[ParsedFile], ctx: Context) -> list[Finding]:
    registry = _registry(ctx)
    out: list[Finding] = []

    for pf in files:
        is_registry_impl = pf.path.endswith(_REGISTRY_FILE)
        os_names = _os_aliases(pf.index)
        for node in pf.index.of(ast.Call, ast.Subscript, ast.Constant):
            read = _env_read(node, os_names)
            if read is not None and not is_registry_impl:
                line, lit = read
                if lit is not None and lit.startswith(_PREFIX):
                    out.append(Finding(
                        RULE, "ad-hoc-env-read", pf.path, line, lit,
                        f"direct environment read of `{lit}` — go "
                        "through features.env_value/env_int"))
            if isinstance(node, ast.Constant) \
                    and isinstance(node.value, str) \
                    and _FLAG_RE.match(node.value) \
                    and node.value not in registry:
                out.append(Finding(
                    RULE, "unregistered-flag", pf.path, node.lineno,
                    node.value,
                    f"`{node.value}` is not declared in "
                    "features.ENV_FLAGS"))

    readme = ctx.text("README.md")
    if readme is None:
        return out
    if "## Environment flags" not in readme:
        out.append(Finding(RULE, "readme-missing-table", "README.md", 1,
                           "", "README has no \"## Environment flags\" "
                           "section"))
        return out
    documented = set(_README_ROW_RE.findall(readme))
    for name in sorted(registry - documented):
        out.append(Finding(RULE, "readme-missing-flag", "README.md", 1,
                           name,
                           f"registered flag `{name}` is missing from "
                           "the README flag table"))
    for name in sorted(documented - registry):
        out.append(Finding(RULE, "readme-unknown-flag", "README.md", 1,
                           name,
                           f"README documents `{name}` but it is not in "
                           "features.ENV_FLAGS"))
    return out
