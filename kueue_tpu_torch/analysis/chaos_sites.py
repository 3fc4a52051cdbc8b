"""Chaos-site registry: doc, code and scenarios must agree exactly.

Three sets of injection-site names are compared:

- **documented** — the reST site table in ``chaos/injector.py``'s
  module docstring (rows opening with ````site```` markers);
- **threaded**   — literal site strings passed to ``crashpoint(...)``
  / ``hit(...)`` anywhere in the scanned code (the points that
  actually consult the injector);
- **armed**      — literal site strings passed to ``arm(...)`` in the
  port's tests, ``tests/test_torch_*.py``, and in ``chip_smoke.py``
  (the scenarios that exercise them).

Findings:

- ``undocumented-site``  threaded but missing from the docstring table
- ``unthreaded-site``    documented but no code point consults it
- ``untested-site``      documented/threaded but no scenario arms it
- ``unknown-armed-site`` a scenario arms a name no site answers to
  (a typo'd arm silently tests nothing)
"""

from __future__ import annotations

import ast
import re

from .core import Context, Finding, ParsedFile

RULE = "chaos-sites"

_INJECTOR_SUFFIX = "chaos/injector.py"
_SMOKE = "chip_smoke.py"
_TEST_NAMES = "test_torch_"      # the port's tests, tests/test_torch_*.py
_DOC_SITE_RE = re.compile(r"^``([a-z_][a-z0-9_.]*)``", re.MULTILINE)


def _literal_site_args(index, attrs: tuple[str, ...]):
    """(site, lineno) for every ``*.<attr>("literal", ...)`` call."""
    for node in index.of(ast.Call):
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr in attrs
                and node.args
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)):
            yield node.args[0].value, node.lineno


def run(files: list[ParsedFile], ctx: Context) -> list[Finding]:
    injector = next((f for f in files
                     if f.path.endswith(_INJECTOR_SUFFIX)), None)
    if injector is None:
        return []

    documented: set[str] = set()
    doc = ast.get_docstring(injector.tree) or ""
    documented.update(_DOC_SITE_RE.findall(doc))

    threaded: dict[str, tuple[str, int]] = {}
    for pf in files:
        if pf.path.endswith(_INJECTOR_SUFFIX):
            continue
        for site, line in _literal_site_args(pf.index,
                                             ("crashpoint", "hit")):
            threaded.setdefault(site, (pf.path, line))

    armed: dict[str, tuple[str, int]] = {}
    arm_files = [pf for pf in files if pf.path == _SMOKE]
    if not arm_files and ctx.text(_SMOKE) is not None:
        arm_files.append(ParsedFile.from_source(_SMOKE, ctx.text(_SMOKE)))
    arm_files += ctx.parse_dir("tests", _TEST_NAMES)
    for pf in arm_files:
        for site, line in _literal_site_args(pf.index, ("arm",)):
            armed.setdefault(site, (pf.path, line))

    out: list[Finding] = []
    known = documented | set(threaded)

    for site in sorted(set(threaded) - documented):
        path, line = threaded[site]
        out.append(Finding(RULE, "undocumented-site", path, line, site,
                           f"site `{site}` is threaded through the code "
                           "but missing from the injector.py site table"))
    for site in sorted(documented - set(threaded)):
        out.append(Finding(RULE, "unthreaded-site", injector.path, 1,
                           site,
                           f"site `{site}` is documented but no "
                           "crashpoint()/hit() call consults it"))
    for site in sorted(known - set(armed)):
        path, line = threaded.get(site, (injector.path, 1))
        out.append(Finding(RULE, "untested-site", path, line, site,
                           f"site `{site}` is never armed by any test "
                           "or soak scenario"))
    for site in sorted(set(armed) - known):
        path, line = armed[site]
        out.append(Finding(RULE, "unknown-armed-site", path, line, site,
                           f"scenario arms `{site}` but no such site "
                           "exists — the fault can never fire"))
    return out
